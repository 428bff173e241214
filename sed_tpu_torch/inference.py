"""High-level batched inference (counterpart of ``sed_tpu.inference``).

Equal-length recordings ride the batch axis through one pass: featurize
(K1 + K2 on CUDA) -> CnnAvgPooling -> sigmoid.  Parallelism over several
cards (``mesh`` in ``sed_tpu``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.ops.featurizer import (logmel_features_batch,
                                          resolve_featurizer_precision)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    return device


def make_batch_predictor(
    model: torch.nn.Module,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    mean: Optional[np.ndarray] = None,
    std: Optional[np.ndarray] = None,
    featurizer_precision=None,
    device="cuda",
):
    """Build ``predict(waveforms) -> scores``.

    ``waveforms``: (batch, samples, channels) array or tensor, float32,
    int16 (PCM16) or uint8 (µ-law); ``scores``: (batch, frames', classes)
    sigmoid confidences, a tensor on ``device``.  ``model`` is moved to
    ``device`` and put in eval mode.

    Parity: this sets ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for the process.
    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and would take the scores far outside the 1e-5
    budget against ``sed_tpu``.
    """
    resolve_featurizer_precision(featurizer_precision)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = model.to(device).eval()

    def as_stat(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                      device=device)

    mean_t, std_t = as_stat(mean), as_stat(std)

    @torch.inference_mode()
    def predict(waveforms) -> torch.Tensor:
        x = torch.as_tensor(waveforms, device=device)
        feats = logmel_features_batch(x, cfg)        # (B, C, T, M): NCHW
        if mean_t is not None:
            feats = (feats - mean_t) / std_t
        return torch.sigmoid(model(feats))

    return predict


def batch_predict_files(
    model: torch.nn.Module,
    audio_paths,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    mean=None,
    std=None,
    featurizer_precision=None,
    device="cuda",
):
    """Read many audio files, group them by sample length, score each group.

    Returns {path: (frames', classes) numpy scores}.  On CUDA the upload is
    double-buffered: while the card scores one group, the host stacks the
    next into pinned memory and copies it on a side stream.
    """
    from sed_tpu_torch.io.audio import read_multichannel_audio

    predictor = make_batch_predictor(model, cfg, mean, std,
                                     featurizer_precision, device)
    device = resolve_device(device)
    by_len = {}
    for path in audio_paths:
        wav = read_multichannel_audio(path, target_fs=cfg.working_sample_rate, cfg=cfg)
        by_len.setdefault(wav.shape[0], []).append((path, wav.astype(np.float32)))
    groups = [g for _, g in sorted(by_len.items())]

    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(group) -> torch.Tensor:
        batch = torch.from_numpy(np.stack([w for _, w in group]))
        if copy_stream is None:
            return batch
        batch = batch.pin_memory()
        with torch.cuda.stream(copy_stream):
            return batch.to(device, non_blocking=True)

    results = {}
    staged = stage(groups[0]) if groups else None
    for gi, group in enumerate(groups):
        batch = staged
        if copy_stream is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_stream(copy_stream)
            batch.record_stream(compute)
        scores = predictor(batch)
        if gi + 1 < len(groups):
            staged = stage(groups[gi + 1])
        scores = scores.cpu().numpy()
        for i, (path, _) in enumerate(group):
            results[path] = scores[i]
    return results
