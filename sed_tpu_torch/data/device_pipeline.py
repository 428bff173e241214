"""Device-resident training pipeline (counterpart of
``sed_tpu.data.device_pipeline``).

The packed training split (spectrogram features, or the waveform samples
of the M5 family) is uploaded to the device once; each train step then

  1. gathers the crop batch from the packed array (one advanced-index
     gather),
  2. applies mix/noise augmentation on the device (reference
     spectograms_dataset.py:112-135, waveform_dataset.py:124-139),
  3. for spectrograms, normalizes (and, in 'Complex' mode, converts to
     log-mel after normalization — the reference transform-order quirk,
     spectograms_dataset.py:104-110),
  4. runs forward, loss, backward and the AMSGrad update.

The host sends only the (batch,) start indices each step, or a (K, batch)
block of them for K steps in one call (:func:`make_multi_step`).

Random draws: ``sed_tpu`` draws with ``jax.random``, which a
``torch.Generator`` cannot reproduce.  The augmentation is therefore split
into its draws (:func:`draw_augmentation`, from a device generator) and a
pure :func:`apply_augmentation`; the tests feed ``sed_tpu``'s draws to the
apply and compare.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.models.layers import global_batch_norm
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.parallel.mesh import local_rows
from sed_tpu_torch.train.loss import weighted_bce_with_logits
from sed_tpu_torch.train.state import TrainState, apply_update
from sed_tpu_torch.utils.precision import full_float32

# Reference augmentation mix probabilities (spectograms_dataset.py:126 /
# waveform_dataset.py:125) as cumulative thresholds on a uniform.
SPEC_MIX_CUM = (0.6, 0.85, 0.95)
WAVE_MIX_CUM = (0.5, 0.8, 0.95)
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


@dataclasses.dataclass
class WaveformBuffers:
    """Packed waveform store on the device."""

    waveform: torch.Tensor       # (channels, total_samples) float32
    labels: torch.Tensor         # (total_samples,) float32 per-start-index labels,
                                 # or (total_samples, classes) when multiclass
    start_indices: torch.Tensor  # (num_starts,) int64, for the mix draws


def _upload(a, device, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


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

    return SpectrogramBuffers(
        features=_upload(features, device),
        events=_upload(dataset.train_event_matrix, device),
        start_indices=_upload(dataset.train_start_indices, device, np.int64),
        mean=_upload(mean, device),
        std=_upload(std, device),
    )


def waveform_buffers_from_dataset(dataset, device="cuda") -> WaveformBuffers:
    """Upload a :class:`WaveformDataset`'s training split, once: the packed
    samples, the labels as float32 and the start indices as int64."""
    return WaveformBuffers(
        waveform=_upload(dataset.long_waveform, device),
        labels=_upload(dataset.all_start_indices_labels, device),
        start_indices=_upload(dataset.possible_start_indices, device, np.int64),
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
        with full_float32():
            mel = torch.matmul(power, fb)
        return mel_ops.power_to_db(mel)

    return transform


@dataclasses.dataclass
class AugmentDraws:
    """The random draws of one augmented batch of B crops.

    ``u_mix`` (B,) uniform: the number of extra crops mixed in, by
    :data:`SPEC_MIX_CUM` or :data:`WAVE_MIX_CUM`; ``ptr`` (B, MAX_MIX)
    int64: which start indices; ``u_noise`` (B,) uniform: the noise gate
    (> 0.5) and its scale; ``noise`` standard normal, the batch's shape (in
    Complex mode without the real/imaginary axis: the noise lands on the
    real part only).
    """

    u_mix: torch.Tensor
    ptr: torch.Tensor
    u_noise: torch.Tensor
    noise: torch.Tensor


def draw_augmentation(generator: torch.Generator, buffers, feats_shape,
                      complex_mode: bool, mesh=None) -> AugmentDraws:
    """Draw from ``generator`` (on the device of ``buffers``, a
    :class:`SpectrogramBuffers` or :class:`WaveformBuffers`).

    With a ``mesh`` ``feats_shape`` is this rank's shard: the draws are made
    for the global batch, as ``sed_tpu``'s replicated key draws them, from
    the generator every rank holds alike, and this rank keeps its rows; so
    the mesh step draws what the single-device step draws."""
    device = buffers.start_indices.device
    rows = slice(None)
    batch = feats_shape[0]
    if mesh is not None:
        batch *= mesh.size
        rows = local_rows(mesh, batch)
        feats_shape = (batch,) + tuple(feats_shape[1:])
    noise_shape = tuple(feats_shape[:-1]) if complex_mode else tuple(feats_shape)
    return AugmentDraws(
        u_mix=torch.rand(batch, generator=generator, device=device)[rows],
        ptr=torch.randint(0, buffers.start_indices.shape[0], (batch, MAX_MIX),
                          generator=generator, device=device)[rows],
        u_noise=torch.rand(batch, generator=generator, device=device)[rows],
        noise=torch.randn(noise_shape, generator=generator, device=device)[rows],
    )


def apply_augmentation(buffers, feats: torch.Tensor, events: torch.Tensor,
                       draws: AugmentDraws, gather_crops: Callable, complex_mode: bool,
                       mix_cum=SPEC_MIX_CUM):
    """Mix + noise (reference spectograms_dataset.py:112-135,
    waveform_dataset.py:124-139) for given draws.

    Each crop is averaged with k extra crops (k from ``u_mix`` by
    ``mix_cum``: :data:`SPEC_MIX_CUM` for spectrograms, :data:`WAVE_MIX_CUM`
    for waveforms), gathered by ``gather_crops(buffers, starts)``, and its
    events, or labels, are the union of theirs (over any trailing axes);
    then, where ``u_noise > 0.5``, noise of std 0.001 + (u_noise + 0.5) *
    0.004 is added (to the real part only in Complex mode, numpy's
    ``complex += real`` semantics).
    """
    batch = feats.shape[0]
    k = sum((draws.u_mix > t).to(torch.int64) for t in mix_cum)           # (B,)
    extra = buffers.start_indices[draws.ptr]                              # (B, MAX_MIX)
    ef, ee = gather_crops(buffers, extra.reshape(-1))
    ef = ef.reshape((batch, MAX_MIX) + tuple(feats.shape[1:]))
    ee = ee.reshape((batch, MAX_MIX) + tuple(events.shape[1:]))
    mask = (torch.arange(MAX_MIX, device=feats.device)[None, :] < k[:, None]).to(feats.dtype)
    fmask = mask.reshape(mask.shape + (1,) * (ef.ndim - 2))
    kdiv = (k + 1).to(feats.dtype).reshape((batch,) + (1,) * (feats.ndim - 1))
    feats = (feats + (ef * fmask).sum(dim=1)) / kdiv
    emask = mask.reshape(mask.shape + (1,) * (ee.ndim - 2))
    events = torch.maximum(events, (ee * emask).amax(dim=1))

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
    """``augment(generator, buffers, feats, events, mesh=None) -> (feats,
    events)``: :func:`draw_augmentation` then :func:`apply_augmentation`."""
    complex_mode = preprocessed_mode != "logMel"
    gather_crops = make_gather_crops(cfg)

    def augment_batch(generator, buffers: SpectrogramBuffers, feats, events, mesh=None):
        draws = draw_augmentation(generator, buffers, feats.shape, complex_mode, mesh)
        return apply_augmentation(buffers, feats, events, draws, gather_crops, complex_mode)

    return augment_batch


def make_spectrogram_train_step(
    cfg: SpectrogramConfig,
    pos_weight: float = 5.0,
    preprocessed_mode: str = "logMel",
    augment: bool = False,
) -> Callable:
    """``step(state, buffers, starts (B,), generator=None, mesh=None) ->
    loss``: gather, augment (with ``augment``, drawing from ``generator``),
    transform, forward, loss, backward and the optimizer step, on the
    buffers' device.  The loss comes back detached, on the device.  Each
    part runs in a ``torch.profiler`` range (``train_step/gather``,
    ``/augment``, ``/transform``, ``/forward``, ``/backward``,
    ``/optimizer``).  The step runs in full float32 (``full_float32``), as
    ``sed_tpu`` trains at full float32 precision.

    ``mesh`` (``parallel.mesh.Mesh``; ``parallel.data_parallel.
    shard_train_step`` passes it): ``starts`` are this rank's shard of the
    global batch; the augmentation is drawn for the global batch
    (:func:`draw_augmentation`), the batch norms normalize with the global
    batch statistics (``models.layers.global_batch_norm``) and the
    gradients are averaged over the ranks before the update
    (``train.state.apply_update``)."""
    gather_crops = make_gather_crops(cfg)
    transform = make_transform(cfg, preprocessed_mode)
    augment_batch = make_augment_batch(cfg, preprocessed_mode)

    @full_float32()
    def step(state: TrainState, buffers: SpectrogramBuffers, starts, generator=None,
             mesh=None):
        with record_function("train_step/gather"):
            starts = torch.as_tensor(starts, device=buffers.features.device)
            feats, events = gather_crops(buffers, starts)
        if augment:
            with record_function("train_step/augment"):
                feats, events = augment_batch(generator, buffers, feats, events, mesh)
        with record_function("train_step/transform"):
            x = transform(buffers, feats)              # (B, C, crop, mel): NCHW
        with record_function("train_step/forward"), global_batch_norm(state.model, mesh):
            state.model.train()
            loss = weighted_bce_with_logits(state.model(x), events, pos_weight,
                                            multi_frame=True)
        apply_update(state, loss, mesh)
        return loss.detach()

    return step


def make_waveform_gather(cfg: WaveformConfig) -> Callable:
    """``gather(buffers, starts (B,)) -> (waves (B, C, frame), labels (B,)
    or (B, classes))``: one advanced-index gather of the packed samples'
    ``unfold`` view, with no index tensor of the crops' size."""
    frame = cfg.frame_size

    def gather(buffers: WaveformBuffers, starts: torch.Tensor):
        starts = starts.to(torch.int64)
        waves = buffers.waveform.unfold(1, frame, 1)[:, starts].movedim(1, 0)
        return waves, buffers.labels[starts]

    return gather


def make_waveform_train_step(
    cfg: WaveformConfig,
    pos_weight: float = 5.0,
    augment: bool = False,
) -> Callable:
    """The raw-waveform step (M5): ``step(state, buffers, starts (B,),
    generator=None, mesh=None) -> loss``.  Gather the crops (NCW, the
    model's layout), augment (with ``augment``: :data:`WAVE_MIX_CUM` mixes
    and noise, drawn from ``generator``), forward, single-frame loss,
    backward and the optimizer step, in the spectrogram step's profiler
    ranges and in full float32; ``mesh`` as the spectrogram step's."""
    gather = make_waveform_gather(cfg)

    @full_float32()
    def step(state: TrainState, buffers: WaveformBuffers, starts, generator=None,
             mesh=None):
        with record_function("train_step/gather"):
            starts = torch.as_tensor(starts, device=buffers.waveform.device)
            waves, labels = gather(buffers, starts)
        if augment:
            with record_function("train_step/augment"):
                draws = draw_augmentation(generator, buffers, waves.shape, False, mesh)
                waves, labels = apply_augmentation(buffers, waves, labels, draws, gather,
                                                   False, WAVE_MIX_CUM)
        with record_function("train_step/forward"), global_batch_norm(state.model, mesh):
            state.model.train()
            loss = weighted_bce_with_logits(state.model(waves), labels, pos_weight,
                                            multi_frame=False)
        apply_update(state, loss, mesh)
        return loss.detach()

    return step


def make_multi_step(step_fn: Callable, steps_per_call: int) -> Callable:
    """``multi(state, buffers, starts_block (K, B), generator=None,
    mesh=None) -> losses (K,)``: K = ``steps_per_call`` calls of ``step_fn``
    (a step of this module, given ``mesh``) in one call, with one upload of
    the block, the losses kept on the device and no host synchronization
    between the steps.

    Identical to K single calls drawing from the same generator, as
    ``sed_tpu``'s scan of K steps is to K single calls with the same key
    splits.  The steps are launched one after another from the host, not
    replayed from a captured CUDA graph.
    """

    def multi(state: TrainState, buffers, starts_block, generator=None,
              mesh=None) -> torch.Tensor:
        block = torch.as_tensor(starts_block, device=buffers.start_indices.device)
        if block.ndim != 2 or block.shape[0] != steps_per_call:
            raise ValueError(f"starts_block must be ({steps_per_call}, batch), "
                             f"got {tuple(block.shape)}")
        return torch.stack([step_fn(state, buffers, starts, generator, mesh)
                            for starts in block])

    return multi
