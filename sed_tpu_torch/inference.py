"""High-level batched inference (counterpart of ``sed_tpu.inference``).

Equal-length recordings ride the batch axis through one pass: featurize
(K1 + K2 on CUDA) -> CnnAvgPooling or MobileNetV1 -> sigmoid scores
(:func:`make_batch_predictor`), or scores, losses and the frame metrics of a
validation batch (:func:`make_batch_evaluator`).  A
single long recording instead goes through
``sed_tpu_torch.parallel.time_shard.windowed_forward`` (``cli/infer.py``).
With a ``mesh`` (``parallel.mesh``, one rank per card) the batch axis is
sharded over the ranks and the scores gathered on every rank; recordings are
independent, so the forward itself communicates nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.ops.featurizer import (logmel_features_batch,
                                          resolve_featurizer_precision)
from sed_tpu_torch.utils.precision import full_float32


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    return device


def emits_scores(model: torch.nn.Module) -> bool:
    """True when ``model``'s forward already applies the sigmoid
    (MobileNetV1 with ``emit='scores'``, the reference's forward)."""
    return getattr(model, "emit", "logits") == "scores"


def make_batch_predictor(
    model: torch.nn.Module,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    mean: Optional[np.ndarray] = None,
    std: Optional[np.ndarray] = None,
    featurizer_precision=None,
    device="cuda",
    *,
    mesh=None,
):
    """Build ``predict(waveforms) -> scores``.

    ``waveforms``: (batch, samples, channels) array or tensor, float32,
    int16 (PCM16) or uint8 (µ-law); ``scores``: (batch, frames', classes)
    sigmoid confidences, a tensor on ``device``.  ``model`` is CnnAvgPooling
    or MobileNetV1, moved to ``device``.  Each call puts it in eval mode
    (running BatchNorm statistics, which the call leaves as they were) and
    leaves it there, and runs in full float32 (``full_float32``: TF32 off
    for the call, the caller's settings back after).  A model that emits
    scores gets no second sigmoid, which would squeeze every score into
    [0.5, 0.731].

    ``mesh`` (keyword only: the positional order already differs from
    ``sed_tpu``'s ``(model, cfg, mesh, mean, std, ...)``): each rank scores
    its contiguous slice of the batch on ``mesh.device`` (``device`` is not
    used; a host array is sliced before the upload) and every rank returns
    the global (batch, frames', classes) scores, as ``sed_tpu``'s global
    array (``parallel.data_parallel.shard_inference``).  The batch must
    divide by the mesh size.

    ``featurizer_precision``: None or 'parity' (K1), 'fast' or 'turbo' (K1t,
    the bf16 tensor-core DFT at bf16x3 or bf16x1), or a raw 'bf16xN' string
    (``resolve_featurizer_precision``).
    """
    precision = resolve_featurizer_precision(featurizer_precision)
    device = resolve_device(device) if mesh is None else mesh.device
    model = model.to(device)
    sigmoid = not emits_scores(model)

    def as_stat(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                      device=device)

    mean_t, std_t = as_stat(mean), as_stat(std)

    @torch.inference_mode()
    @full_float32()
    def predict(waveforms) -> torch.Tensor:
        model.eval()
        x = torch.as_tensor(waveforms, device=device)
        feats = logmel_features_batch(x, cfg, pallas_precision=precision)   # NCHW
        if mean_t is not None:
            feats = (feats - mean_t) / std_t
        out = model(feats)
        return torch.sigmoid(out) if sigmoid else out

    if mesh is not None:
        from sed_tpu_torch.parallel.data_parallel import shard_inference

        return shard_inference(predict, mesh)
    return predict


def batch_predict_files(
    model: torch.nn.Module,
    audio_paths,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    mean=None,
    std=None,
    featurizer_precision=None,
    device="cuda",
    *,
    mesh=None,
):
    """Read many audio files, group them by sample length, score each group.

    Returns {path: (frames', classes) numpy scores}.  On CUDA the upload is
    double-buffered: while the card scores one group, the host stacks the
    next into pinned memory and copies it on a side stream.  With ``mesh``
    (keyword only, see :func:`make_batch_predictor`) every rank reads the
    files, pads each group with zero rows to a multiple of the mesh size,
    uploads and scores its slice, and returns every file's scores; the
    padding rows are dropped.
    """
    from sed_tpu_torch.io.audio import read_multichannel_audio
    from sed_tpu_torch.parallel.mesh import gather_rows, local_rows

    device = resolve_device(device) if mesh is None else mesh.device
    predictor = make_batch_predictor(model, cfg, mean, std, featurizer_precision, device)
    n_dev = 1 if mesh is None else mesh.size
    by_len = {}
    for path in audio_paths:
        wav = read_multichannel_audio(path, target_fs=cfg.working_sample_rate, cfg=cfg)
        by_len.setdefault(wav.shape[0], []).append((path, wav.astype(np.float32)))
    groups = [g for _, g in sorted(by_len.items())]

    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(group) -> torch.Tensor:
        batch = np.stack([w for _, w in group])
        pad = (-len(batch)) % n_dev
        if pad:
            batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
        batch = torch.from_numpy(batch[local_rows(mesh, len(batch))])
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
        scores = gather_rows(mesh, predictor(batch))
        if gi + 1 < len(groups):
            staged = stage(groups[gi + 1])
        scores = scores.cpu().numpy()
        for i, (path, _) in enumerate(group):
            results[path] = scores[i]
    return results


def make_batch_evaluator(
    model: torch.nn.Module,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    mean: Optional[np.ndarray] = None,
    std: Optional[np.ndarray] = None,
    pos_weight: float = 5.0,
    device="cuda",
    *,
    mesh=None,
):
    """Build ``evaluate(waveforms, targets)``: score and grade a batch of
    equal-length validation recordings on ``device`` in one pass.

    ``waveforms``: (batch, samples, channels) as for
    :func:`make_batch_predictor` (float32, int16 or uint8); ``targets``:
    (batch, frames, classes) 0/1.  Featurize (K1 + K2 on CUDA), normalize,
    run the model, truncate logits and targets to the common frame count
    (utils/common.py:20-22), then per recording the weighted BCE and the
    21-threshold metric sweep (``utils.metrics.calculate_metrics_torch``).
    Returns tensors on ``device``: (scores (B, F, C), losses (B,), recalls
    (B, 21), precisions (B, 21), APs (B,)).  ``model`` must emit logits (a
    MobileNetV1 needs ``emit='logits'``).  Each call puts the model in eval
    mode and leaves it there, in full float32, as
    :func:`make_batch_predictor`'s does.  With ``mesh`` (keyword only) each
    rank grades its slice of the recordings and every rank returns all five
    results for the whole batch.
    """
    from sed_tpu_torch.train.loss import weighted_bce_elementwise
    from sed_tpu_torch.utils.metrics import calculate_metrics_torch

    if emits_scores(model):
        raise ValueError("make_batch_evaluator needs a model that emits logits "
                         "(MobileNetV1(emit='logits'))")
    device = resolve_device(device) if mesh is None else mesh.device
    model = model.to(device)

    def as_stat(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32),
                                                      device=device)

    mean_t, std_t = as_stat(mean), as_stat(std)

    @torch.inference_mode()
    @full_float32()
    def evaluate(waveforms, targets):
        model.eval()
        x = torch.as_tensor(waveforms, device=device)
        feats = logmel_features_batch(x, cfg)
        if mean_t is not None:
            feats = (feats - mean_t) / std_t
        logits = model(feats)
        t = torch.as_tensor(targets, device=device).to(torch.float32)
        n = min(logits.shape[1], t.shape[1])
        logits, t = logits[:, :n], t[:, :n]
        losses = weighted_bce_elementwise(logits, t, pos_weight).mean(dim=(1, 2))
        scores = torch.sigmoid(logits)
        recalls, precisions, aps = calculate_metrics_torch(scores, t)
        return scores, losses, recalls, precisions, aps

    if mesh is not None:
        from sed_tpu_torch.parallel.mesh import gather_rows, local_rows

        def sharded(waveforms, targets):
            rows = local_rows(mesh, waveforms.shape[0])
            return tuple(gather_rows(mesh, r) for r in evaluate(waveforms[rows], targets[rows]))

        return sharded
    return evaluate
