"""Training orchestration and whole-recording evaluation (counterpart of
``sed_tpu.train.loop``).

Reference: train.py:12-132 (eval + train).  The hot loop is the device step
of :mod:`sed_tpu_torch.data.device_pipeline`, for the spectrogram family
(CnnAvgPooling, MobileNetV1) or the raw waveform (M5), one step or K steps
a call; this module owns epochs, logging (the reference's im/sec,
train.py:113-115), periodic evaluation on whole validation recordings,
metrics.jsonl, diagnostic images, checkpoints and a profiler trace of steps
10-20.  With a ``mesh`` every rank runs the loop on its shard of each batch
(``parallel.data_parallel``), and the primary rank alone logs, evaluates
and writes.
"""

from __future__ import annotations

import os
from time import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sed_tpu_torch.configs import SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data.device_pipeline import (make_multi_step, make_spectrogram_train_step,
                                                make_waveform_train_step,
                                                spectrogram_buffers_from_dataset,
                                                waveform_buffers_from_dataset)
from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.parallel.mesh import barrier
from sed_tpu_torch.train.checkpoint import save_checkpoint
from sed_tpu_torch.train.loss import weighted_bce_with_logits_np
from sed_tpu_torch.train.state import init_state, make_eval_forward
from sed_tpu_torch.utils.metrics import calculate_metrics
from sed_tpu_torch.utils.precision import full_float32
from sed_tpu_torch.utils.progress import ProgressPlotter

MODES = ("spectogram", "waveform")
# M5 evaluation pads a recording's frames to a multiple of this (sed_tpu's
# bucket; frames are independent in eval mode, so the padding changes no
# score).
WAVEFORM_EVAL_BUCKET = 32
# The profiler window of train(profile_dir=...): steps 10 to 20.
PROFILE_STEPS = (10, 20)


def _sigmoid_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-x)),
                    np.exp(x) / (1.0 + np.exp(x))).astype(np.float32)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
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

    Spectrogram mode: each validation recording goes through the fully
    convolutional model as one (1, channels, frames, mel) batch on the
    model's device: for CnnAvgPooling through
    ``parallel.time_shard.bucketed_forward_exact`` (a bucket-padded main
    pass and an exact tail pass, so a set of mixed lengths runs a few
    distinct shapes), otherwise as it is.  Waveform mode: a recording is a
    batch of hop-strided (frames, channels, samples) frames, each scoring
    one logit a class; the batch axis is padded to a multiple of
    :data:`WAVEFORM_EVAL_BUCKET`.  The model runs in eval mode.  Losses,
    sigmoid and metrics run on the host in numpy.  Returns (losses,
    recall_sets, precision_sets, APs, event_metrics), the last a
    per-recording list of event- and segment-based metric dicts, or []
    when ``cfg`` is None.  ``state`` is the :class:`TrainState` whose model
    is evaluated (``model`` is kept for ``sed_tpu``'s signature).
    """
    _check_mode(mode)
    model = state.model if state is not None else model
    forward = make_eval_forward(model)
    device = next(model.parameters()).device
    losses, recal_sets, precision_sets, aps = [], [], [], []
    event_ms = []
    debug = []  # (input, output_scores, target, name)

    model_config = getattr(model, "model_config", None) if mode == "spectogram" else None
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
        if mode == "waveform":
            # (frames, channels, samples): a batch of frames, NCW.
            n = x.shape[0]
            padded = WAVEFORM_EVAL_BUCKET * -(-n // WAVEFORM_EVAL_BUCKET)
            logits = forward(F.pad(x, (0, 0, 0, 0, 0, padded - n)))[:n].cpu().numpy()
            loss = weighted_bce_with_logits_np(logits, np.asarray(target_np), pos_weight,
                                               multi_frame=False)
            scores = _sigmoid_np(logits)
            target = np.asarray(target_np)
            if target.ndim == 1:   # scalar labels -> (frames, 1) like the scores
                target = target.reshape(-1, 1)
            plot_input = np.transpose(np.asarray(input_np), (1, 0, 2))
        else:
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


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, profile_dir: str, first: int, last: int) -> str:
    """Wait for the card, stop ``prof`` and export its Chrome trace into
    ``profile_dir``; returns the file's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"train_steps_{first}-{last}.json")
    prof.export_chrome_trace(path)
    print(f"\t- profiler trace of steps {first}-{last}: {path}")
    return path


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

    ``mode`` 'spectogram' trains CnnAvgPooling or MobileNetV1 on a
    :class:`SpectrogramDataset`, 'waveform' M5 on a :class:`WaveformDataset`.
    The model is initialized from ``seed`` (a CPU ``torch.Generator``) and
    trained on ``device``, unless ``initial_state`` (a :class:`TrainState`,
    e.g. from ``load_checkpoint``) is given, whose model then trains.  The
    augmentation draws come from a device generator seeded ``seed + 1``.
    Every ``log_freq`` steps: the im/sec line, an evaluation, a
    metrics.jsonl record and ``checkpoints/iteration_{n}.pt``.  The loop
    runs in full float32 (``full_float32``).

    ``steps_per_call`` K > 1 runs K steps a call
    (``device_pipeline.make_multi_step``) on a (K, batch) block of start
    indices; num_steps and log_freq must be multiples of K, and so must a
    resumed state's step.  ``profile_dir``: a ``torch.profiler`` trace of
    steps 10-20 (on block edges with K > 1), exported there as a Chrome
    trace file.  Returns the final :class:`TrainState`.

    ``mesh`` (``parallel.mesh.Mesh``): data-parallel training, one rank per
    device, every rank calling ``train`` with the same arguments (the SPMD
    contract).  ``batch_size`` is the global batch and must divide by the
    mesh size; each rank's step takes its shard of every batch
    (``parallel.data_parallel.shard_train_step``) and the model and buffers
    live on ``mesh.device`` (``device`` is not used).  The state stays
    replicated: BatchNorm uses the global batch statistics and the
    gradients are averaged before each update.  The primary rank alone
    prints, evaluates, plots, writes metrics.jsonl and the checkpoints and
    traces, and the ranks wait for it at each log point, so the run writes
    the files a one-process run writes.
    """
    _check_mode(mode)
    if mesh is not None and batch_size % mesh.size != 0:
        raise ValueError(
            f"global batch_size={batch_size} must be divisible by the mesh "
            f"size {mesh.size}"
        )
    if steps_per_call > 1 and (num_steps % steps_per_call or log_freq % steps_per_call):
        raise ValueError("num_steps and log_freq must be multiples of steps_per_call")
    if steps_per_call > 1 and initial_state is not None \
            and int(initial_state.step) % steps_per_call:
        raise ValueError(
            f"resumed step {int(initial_state.step)} is not a multiple of "
            f"steps_per_call={steps_per_call}"
        )
    device = resolve_device(device) if mesh is None else mesh.device
    primary = mesh is None or mesh.rank == 0

    def say(*args):
        if primary:
            print(*args)

    say("Training:")
    say("\t- Using device: ", device)
    if primary:
        os.makedirs(os.path.join(outputs_dir, "checkpoints"), exist_ok=True)
    if not primary:
        profile_dir = None
    plotter = ProgressPlotter()

    if mode == "spectogram":
        cfg = cfg or SpectrogramConfig()
        buffers = spectrogram_buffers_from_dataset(dataset, device)
        step_fn = make_spectrogram_train_step(cfg, pos_weight, preprocessed_mode, augment)
    else:
        cfg = cfg or WaveformConfig()
        buffers = waveform_buffers_from_dataset(dataset, device)
        step_fn = make_waveform_train_step(cfg, pos_weight, augment)
    if steps_per_call > 1:
        step_fn = make_multi_step(step_fn, steps_per_call)
    if mesh is not None:
        from sed_tpu_torch.parallel.data_parallel import shard_train_step

        step_fn = shard_train_step(step_fn, mesh, steps_per_call=steps_per_call)
    state = initial_state if initial_state is not None else init_state(model, lr, device, seed)

    from sed_tpu_torch.models.describe import describe_cnn, describe_m5

    if mode == "waveform":
        say(describe_m5(state.model))
    elif hasattr(state.model, "model_config"):
        say(describe_cnn(state.model, cfg))

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
    starts_block = []   # the batches of one call with steps_per_call > 1
    profiler, profiled_from = None, 0
    with full_float32():
        while iterations < num_steps:
            for starts in dataset.epoch_start_indices(batch_size):
                if profile_dir and profiler is None and iterations >= PROFILE_STEPS[0]:
                    profiler, profiled_from = _start_profile(device), iterations
                if steps_per_call > 1:
                    starts_block.append(starts)
                    if len(starts_block) < steps_per_call:
                        continue
                    losses = step_fn(state, buffers, np.stack(starts_block), generator)
                    pending_losses.extend(losses.unbind())
                    starts_block = []
                    iterations += steps_per_call
                else:
                    pending_losses.append(step_fn(state, buffers, starts, generator))
                    iterations += 1
                if profiler is not None and iterations >= PROFILE_STEPS[1]:
                    _stop_profile(profiler, device, profile_dir, profiled_from, iterations)
                    profiler, profile_dir = None, None

                if iterations % log_freq == 0:
                    losses = torch.stack(pending_losses).cpu().tolist()
                    pending_losses = []
                    if primary:
                        for loss in losses:
                            plotter.report_train_loss(loss)
                        # Same definition as the reference (train.py:113-115),
                        # counting only the steps this call has run.
                        im_sec = (iterations - start_iterations) * batch_size / (
                            time() - training_start_time)
                        print(f"epoch: {epoch}, step: {iterations}, loss: {losses[-1]:.2f}, "
                              f"im/sec: {im_sec:.1f}")
                        results = evaluate(model, state, dataset, mode, pos_weight,
                                           outputs_dir, iterations,
                                           limit_val_samples=limit_val_samples,
                                           make_plots=make_plots, cfg=cfg)
                        report_log_point(plotter, outputs_dir, iterations, results,
                                         make_plots)
                        save_checkpoint(state, outputs_dir, iterations)
                    barrier(mesh)

                if iterations >= num_steps:
                    break
            epoch += 1
        if profiler is not None:   # the run ended inside the window
            _stop_profile(profiler, device, profile_dir, profiled_from, iterations)

    return state
