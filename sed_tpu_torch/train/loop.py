"""Training orchestration and whole-recording evaluation (counterpart of the
spectrogram path of ``sed_tpu.train.loop``).

Reference: train.py:12-132 (eval + train).  The hot loop is the device step
of :mod:`sed_tpu_torch.data.device_pipeline`; this module owns epochs,
logging (the reference's im/sec, train.py:113-115), periodic evaluation on
whole validation recordings, metrics.jsonl, diagnostic images and
checkpoints.  Not ported yet, and refused by name: the waveform (M5) mode,
``steps_per_call`` > 1, ``mesh`` and ``profile_dir``.
"""

from __future__ import annotations

import os
from time import time
from typing import Optional

import numpy as np
import torch

from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.data.device_pipeline import (make_spectrogram_train_step,
                                                spectrogram_buffers_from_dataset)
from sed_tpu_torch.inference import no_tf32, resolve_device
from sed_tpu_torch.train.checkpoint import save_checkpoint
from sed_tpu_torch.train.loss import weighted_bce_with_logits_np
from sed_tpu_torch.train.state import init_state, make_eval_forward
from sed_tpu_torch.utils.metrics import calculate_metrics
from sed_tpu_torch.utils.progress import ProgressPlotter


def _sigmoid_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-x)),
                    np.exp(x) / (1.0 + np.exp(x))).astype(np.float32)


def _refuse_waveform(mode: str) -> None:
    if mode == "waveform":
        raise NotImplementedError("waveform (M5) training is not ported yet "
                                  "(see ROADMAP.md, slice B part 2)")
    if mode != "spectogram":
        raise ValueError(f"mode must be 'spectogram' or 'waveform', got {mode!r}")


def evaluate(
    model,
    state,
    dataset,
    mode: str,
    pos_weight: float,
    outputs_dir: str,
    iteration: int,
    limit_val_samples: Optional[int] = None,
    make_plots: bool = True,
    cfg=None,
):
    """Whole-recording evaluation (reference: train.py:12-74).

    Each validation recording goes through the fully convolutional model as
    one (1, channels, frames, mel) batch on the model's device: for
    CnnAvgPooling through ``parallel.time_shard.bucketed_forward_exact``
    (a bucket-padded main pass and an exact tail pass, so a set of mixed
    lengths runs a few distinct shapes), otherwise as it is.  Losses,
    sigmoid and metrics run on the host in numpy.  Returns (losses,
    recall_sets, precision_sets, APs, event_metrics), the last a
    per-recording list of event- and segment-based metric dicts, or []
    when ``cfg`` is None.  ``state`` is the :class:`TrainState` whose model
    is evaluated (``model`` is kept for ``sed_tpu``'s signature).
    """
    _refuse_waveform(mode)
    model = state.model if state is not None else model
    forward = make_eval_forward(model)
    device = next(model.parameters()).device
    losses, recal_sets, precision_sets, aps = [], [], [], []
    event_ms = []
    debug = []  # (input, output_scores, target, name)

    model_config = getattr(model, "model_config", None)
    if model_config is not None:
        from sed_tpu_torch.models.cnn import num_pools
        from sed_tpu_torch.parallel.time_shard import (bucketed_forward_exact,
                                                       pool_product, receptive_field)

        stride = pool_product(model_config)
        # The exactness argument assumes the interpolate ratio matches the
        # actual time decimation (true for every shipped config).
        if 2 ** num_pools(model_config) != stride:
            model_config = None
        else:
            rf = receptive_field(model_config)
            halo = stride * (-(-(rf // 2 + 1) // stride))

    for input_np, target_np, name in dataset.get_validation_sampler(limit_val_samples):
        x = torch.from_numpy(np.ascontiguousarray(input_np, np.float32)).to(device)
        if model_config is not None:
            logits = bucketed_forward_exact(forward, x, stride, halo)
        else:
            logits = forward(x)
        logits = logits.cpu().numpy()
        loss = weighted_bce_with_logits_np(logits, np.asarray(target_np), pos_weight,
                                           multi_frame=True)
        scores = _sigmoid_np(logits)[0]
        target = np.asarray(target_np)[0]
        plot_input = np.asarray(input_np)[0]

        recal_vals, precision_vals, ap = calculate_metrics(scores, target)
        losses.append(float(loss))
        recal_sets.append(recal_vals)
        precision_sets.append(precision_vals)
        aps.append(ap)
        if cfg is not None:
            from sed_tpu_torch.utils.event_metrics import (
                _pooled, event_metrics_per_class_from_matrices,
                segment_metrics_from_matrices, segment_metrics_per_class_from_matrices)
            from sed_tpu_torch.utils.metrics import calculate_metrics_per_class

            # Truncate to the common frame count, as the loss does.
            n = min(scores.shape[0], target.shape[0])
            per_class = event_metrics_per_class_from_matrices(
                scores[:n], target[:n], cfg.frames_per_second)
            m = _pooled({k: sum(d[k] for d in per_class) for k in ("tp", "fp", "fn")})
            m["per_class"] = per_class
            m["segment"] = segment_metrics_from_matrices(
                scores[:n], target[:n], cfg.frames_per_second)
            m["segment_per_class"] = segment_metrics_per_class_from_matrices(
                scores[:n], target[:n], cfg.frames_per_second)
            m["frame_ap_per_class"] = calculate_metrics_per_class(
                scores[:n], target[:n])[2].tolist()
            event_ms.append(m)
        debug.append((plot_input, scores, target, name))

    if make_plots and debug:
        _plot_best_worst(debug, losses, aps, mode, outputs_dir, iteration, cfg)
    return losses, recal_sets, precision_sets, aps, event_ms


def _plot_best_worst(debug, losses, aps, mode, outputs_dir, iteration, cfg):
    """Best/worst sample images by loss and AP (reference: train.py:60-72)."""
    from sed_tpu_torch.utils.plotting import plot_sample_features

    n = len(debug)
    for metric_name, values, named_indices in [
        ("loss", losses, [("worst", -1), ("2-worst", -2), ("3-worst", -3), ("best", 0)]),
        ("AP", aps, [("worst", 0), ("best", -1)]),
    ]:
        order = np.argsort(values)
        for rank_name, idx in named_indices:
            if abs(idx) > n - (idx >= 0):
                continue  # fewer validation samples than ranks requested
            sample_idx = order[idx]
            plot_input, scores, target, name = debug[sample_idx]
            plot_sample_features(
                plot_input,
                mode=mode,
                output=scores,
                target=target,
                file_name=f"{name} {metric_name} {values[sample_idx]:.2f}",
                plot_path=os.path.join(outputs_dir, "images", f"Iter-{iteration}",
                                       f"{metric_name}-{rank_name}.png"),
                cfg=cfg,
            )


def report_log_point(plotter: ProgressPlotter, outputs_dir: str, iteration: int,
                     results, make_plots: bool) -> None:
    """Feed one evaluation's results to ``plotter`` and append its
    metrics.jsonl record (and draw the PNGs with ``make_plots``)."""
    from sed_tpu_torch.utils.event_metrics import (macro_average_classes, micro_average,
                                                   micro_average_segments)

    val_losses, recal_sets, precision_sets, aps, event_ms = results
    if not val_losses:
        return
    plotter.report_validation_metrics(val_losses, recal_sets, precision_sets, aps, iteration)
    if event_ms:
        plotter.report_event_metrics(micro_average(event_ms))
        plotter.report_segment_metrics(micro_average_segments(
            [m["segment"] for m in event_ms]))
        plotter.report_per_class_metrics(
            frame_ap_per_class=np.mean([m["frame_ap_per_class"] for m in event_ms],
                                       axis=0).tolist(),
            event_macro=macro_average_classes([m["per_class"] for m in event_ms]),
            segment_macro=macro_average_classes([m["segment_per_class"] for m in event_ms]),
        )
    plotter.record(outputs_dir)  # metrics.jsonl always written
    if make_plots:
        plotter.plot(outputs_dir)


def train(
    model,
    dataset,
    mode: str,
    num_steps: int,
    lr: float,
    log_freq: int,
    outputs_dir: str,
    batch_size: int = 128,
    pos_weight: float = 5.0,
    augment: bool = False,
    preprocessed_mode: str = "logMel",
    cfg=None,
    seed: int = 0,
    initial_state=None,
    make_plots: bool = True,
    limit_val_samples: Optional[int] = 3,
    profile_dir: Optional[str] = None,
    mesh=None,
    steps_per_call: int = 1,
    device="cuda",
):
    """Train loop (reference: train.py:77-132) on the device pipeline.

    The model is initialized from ``seed`` (a CPU ``torch.Generator``) and
    trained on ``device``, unless ``initial_state`` (a :class:`TrainState`,
    e.g. from ``load_checkpoint``) is given, whose model then trains.  The
    augmentation draws come from a device generator seeded ``seed + 1``.
    Every ``log_freq`` steps: the im/sec line, an evaluation, a
    metrics.jsonl record and ``checkpoints/iteration_{n}.pt``.  TF32 is
    turned off for the process (``inference.no_tf32``).  Returns the final
    :class:`TrainState`.
    """
    _refuse_waveform(mode)
    unported = [name for name, on in (("mesh", mesh is not None),
                                      ("steps_per_call > 1", steps_per_call != 1),
                                      ("profile_dir", bool(profile_dir))) if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)} (see ROADMAP.md)")
    device = resolve_device(device)
    no_tf32()
    print("Training:")
    print("\t- Using device: ", device)
    os.makedirs(os.path.join(outputs_dir, "checkpoints"), exist_ok=True)
    plotter = ProgressPlotter()

    cfg = cfg or SpectrogramConfig()
    buffers = spectrogram_buffers_from_dataset(dataset, device)
    step_fn = make_spectrogram_train_step(cfg, pos_weight, preprocessed_mode, augment)
    state = initial_state if initial_state is not None else init_state(model, lr, device, seed)

    if hasattr(state.model, "model_config"):
        from sed_tpu_torch.models.describe import describe_cnn

        print(describe_cnn(state.model, cfg))

    generator = torch.Generator(device=device).manual_seed(seed + 1)
    iterations = int(state.step)
    start_iterations = iterations
    epoch = 0
    training_start_time = time()

    if len(dataset) < batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} training start indices, fewer than "
            f"batch_size={batch_size}; no full batch can be formed"
        )

    # Per-step losses stay on the device; they come to the host at log
    # points only, so the host keeps the card's queue full.
    pending_losses = []
    while iterations < num_steps:
        for starts in dataset.epoch_start_indices(batch_size):
            pending_losses.append(step_fn(state, buffers, starts, generator))
            iterations += 1

            if iterations % log_freq == 0:
                losses = torch.stack(pending_losses).cpu().tolist()
                pending_losses = []
                for loss in losses:
                    plotter.report_train_loss(loss)
                # Same definition as the reference (train.py:113-115),
                # counting only steps run in this session.
                im_sec = (iterations - start_iterations) * batch_size / (
                    time() - training_start_time)
                print(f"epoch: {epoch}, step: {iterations}, loss: {losses[-1]:.2f}, "
                      f"im/sec: {im_sec:.1f}")
                results = evaluate(model, state, dataset, mode, pos_weight, outputs_dir,
                                   iterations, limit_val_samples=limit_val_samples,
                                   make_plots=make_plots, cfg=cfg)
                report_log_point(plotter, outputs_dir, iterations, results, make_plots)
                save_checkpoint(state, outputs_dir, iterations)

            if iterations >= num_steps:
                break
        epoch += 1

    return state
