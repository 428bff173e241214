"""Offline feature preprocessing job (counterpart of ``sed_tpu.data.preprocess``).

Reference: dataset/spectogram/preprocess.py:60-86 (``preprocess_data``) —
per file: read audio -> STFT -> (log-mel if mode) -> pickle
``{'features', 'start_times', 'end_times'}``; then the global per-bin
mean/std over all frames, pickled separately.

The log-mel runs on ``device`` through the port's featurizer: K1 (STFT
power) then K2 (mel-log) on CUDA, once per file, their plain versions on the
CPU.  'Complex' mode runs the STFT on ``device`` and keeps the complex
spectrum on the host.  File I/O and pickling stay on the host; the pickles
are ``sed_tpu``'s format (with ``class_indices``).  ``workers > 0`` reads
the files ahead on the native reader's C++ threads while the device
featurizes, as ``sed_tpu``'s pipelined acquisition stage does.
"""

from __future__ import annotations

import os
import pickle
import random
import time

import numpy as np
import torch

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.inference import resolve_device
from sed_tpu_torch.io.audio import read_multichannel_audio
from sed_tpu_torch.io.labels import event_class_indices
from sed_tpu_torch.ops.featurizer import logmel_features, multichannel_stft_host


def calculate_scalar_of_tensor(x: np.ndarray):
    """Per-last-axis mean/std (reference: preprocess.py:48-57)."""
    if x.ndim == 2:
        axis = 0
    elif x.ndim == 3:
        axis = (0, 1)
    else:
        raise ValueError(f"expected 2-D or 3-D features, got {x.ndim}-D")
    return np.mean(x, axis=axis), np.std(x, axis=axis)


def featurize_waveform(
    waveform: np.ndarray,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    preprocess_mode: str = "logMel",
    fft_impl: str = "auto",
    device="cuda",
) -> np.ndarray:
    """(samples, channels) float waveform -> (channels, frames, bins/mels)
    numpy, computed on ``device``."""
    device = resolve_device(device)
    waveform = np.asarray(waveform, np.float32)
    if preprocess_mode == "logMel":
        with torch.inference_mode():
            feats = logmel_features(torch.from_numpy(waveform).to(device), cfg, fft_impl)
            return feats.cpu().numpy()
    return multichannel_stft_host(waveform, cfg, fft_impl, device=device).astype(np.complex64)


def featurize_file(
    audio_path: str,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    preprocess_mode: str = "logMel",
    fft_impl: str = "auto",
    device="cuda",
    timings=None,
) -> np.ndarray:
    """Read one file and compute (channels, frames, bins/mels) features.
    ``timings``: a dict that accumulates the seconds of the ``read`` and
    the ``featurize`` stage (which ends with the features on the host)."""
    t0 = time.perf_counter()
    waveform = read_multichannel_audio(audio_path, target_fs=cfg.working_sample_rate, cfg=cfg)
    t1 = time.perf_counter()
    feats = featurize_waveform(waveform, cfg, preprocess_mode, fft_impl, device)
    if timings is not None:
        timings["read"] = timings.get("read", 0.0) + t1 - t0
        timings["featurize"] = timings.get("featurize", 0.0) + time.perf_counter() - t1
    return feats


def _waveform_producer(paths, cfg, workers, out_queue):
    """Producer thread: decode + channel policy + resample files in groups of
    ``max(2, workers)`` on the native reader's threads, ahead of the
    featurize/pickle consumer.  Puts ``(index, waveform, None)`` in order; a
    group that fails is re-read file by file, so a file that fails to decode
    is put as ``(index, None, its exception)`` and the consumer raises it at
    the same file as the sequential path would."""
    from sed_tpu_torch.io.audio import read_multichannel_audio_batch

    group = max(2, workers)
    for base in range(0, len(paths), group):
        chunk = paths[base: base + group]
        try:
            waves = read_multichannel_audio_batch(chunk, target_fs=cfg.working_sample_rate,
                                                  cfg=cfg, workers=workers)
        except Exception:  # noqa: BLE001 - re-read per file to attribute the error
            for j, p in enumerate(chunk):
                try:
                    w = read_multichannel_audio_batch([p], target_fs=cfg.working_sample_rate,
                                                      cfg=cfg)[0]
                    out_queue.put((base + j, w, None))
                except Exception as e:  # noqa: BLE001 - raised by the consumer
                    out_queue.put((base + j, None, e))
            continue
        for j, w in enumerate(waves):
            out_queue.put((base + j, w, None))


def _pipelined_waveforms(paths, cfg, workers):
    """The waveforms of ``paths`` in order, read ahead by
    :func:`_waveform_producer` on a daemon thread (a bounded queue of
    ``2 * max(2, workers)``); a file's read error is raised at its turn."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=2 * max(2, workers))
    threading.Thread(target=_waveform_producer, args=(paths, cfg, workers, q),
                     daemon=True).start()
    for i in range(len(paths)):
        idx, w, err = q.get()
        assert idx == i  # the producer puts in order
        if err is not None:
            raise err
        yield w


def preprocess_data(
    audio_path_and_labels,
    output_dir: str,
    output_mean_std_file: str,
    preprocess_mode: str = "logMel",
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    fft_impl: str = "auto",
    plot_sample: bool = True,
    workers: int = 0,
    device="cuda",
) -> None:
    """Featurize + pickle every labeled file, then the global mean/std.

    ``workers > 0`` runs the acquisition stage (WAV decode, channel policy,
    resampling) as a pipelined producer: files are read ``max(2, workers)``
    at a time on the native reader's ``workers`` C++ threads while this
    thread featurizes on ``device`` and pickles, so the read of the next
    files overlaps the featurizer.  At the working rate the pickles and
    mean/std equal ``workers=0``'s; resampled sources go through the
    native resampler instead of scipy's (the same Kaiser design, both within
    -140 dBFS of a float64 oracle), not bit-equal.  ``plot_sample`` draws
    one random file's log-mel (``data_sample.png``) when matplotlib is
    installed and says it skipped the plot otherwise.
    """
    print("Preprocessing collected data")
    os.makedirs(output_dir, exist_ok=True)

    items = list(audio_path_and_labels)
    waves = None
    if workers > 0 and len(items) > 1:
        waves = _pipelined_waveforms([it[0] for it in items], cfg, workers)
    all_features = []
    for item in items:
        audio_path, start_times, end_times, audio_name = item
        if waves is not None:
            feature = featurize_waveform(next(waves), cfg, preprocess_mode, fft_impl, device)
        else:
            feature = featurize_file(audio_path, cfg, preprocess_mode, fft_impl, device)
        all_features.append(feature)
        output_path = os.path.join(
            output_dir, audio_name + f"_{preprocess_mode}_features_and_labels.pkl"
        )
        with open(output_path, "wb") as f:
            # Superset of the reference pickle format (preprocess.py:74-76):
            # class_indices carries per-event class identity.
            pickle.dump(
                {"features": feature, "start_times": start_times,
                 "end_times": end_times,
                 "class_indices": event_class_indices(item)}, f
            )

    all_features = np.concatenate(all_features, axis=1)
    mean, std = calculate_scalar_of_tensor(all_features)
    with open(output_mean_std_file, "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)

    if plot_sample and items:
        from sed_tpu_torch.utils.plotting import require_matplotlib

        try:
            require_matplotlib()
        except RuntimeError as e:
            print(f"data-sample plot skipped: {e}")
            return
        item = random.choice(items)
        audio_path, start_times, end_times, audio_name = item
        analyze_data_sample(
            audio_path, start_times, end_times, audio_name,
            os.path.join(os.path.dirname(output_mean_std_file), "data_sample.png"),
            cfg, class_indices=event_class_indices(item), device=device,
        )


def analyze_data_sample(audio_path, start_times, end_times, audio_name, plot_path,
                        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
                        class_indices=None, device="cuda") -> None:
    """Debug plot + shape walkthrough (reference: preprocess.py:89-113)."""
    from sed_tpu_torch.data.events import create_event_matrix
    from sed_tpu_torch.io.audio import read_wav
    from sed_tpu_torch.utils.plotting import plot_sample_features

    org_audio, org_sample_rate = read_wav(audio_path)
    audio = read_multichannel_audio(audio_path, target_fs=cfg.working_sample_rate, cfg=cfg)
    feature = featurize_waveform(audio, cfg, "logMel", device=device)
    event_matrix = create_event_matrix(feature.shape[1], start_times, end_times, cfg,
                                       class_indices=class_indices)
    plot_sample_features(feature, mode="spectogram", target=event_matrix,
                         plot_path=plot_path, file_name=audio_name, cfg=cfg)

    signal_time = audio.shape[0] / cfg.working_sample_rate
    fps = cfg.working_sample_rate / cfg.hop_size
    print(f"Data sample analysis: {audio_name}")
    print(f"\tOriginal audio: {org_audio.shape} sample_rate={org_sample_rate}")
    print(f"\tsingle channel audio: {audio.shape}, sample_rate={cfg.working_sample_rate}")
    print(f"\tSignal time is (num_samples/sample_rate)={signal_time:.1f}s")
    print(f"\tSTFT FPS is (sample_rate/hop_size)={fps}")
    print(f"\tTotal number of frames is (FPS*signal_time)={fps * signal_time:.1f}")
    print(f"\tEach frame covers {cfg.frame_size} samples or "
          f"{cfg.frame_size / cfg.working_sample_rate:.3f} seconds padded into "
          f"{cfg.nfft} samples and allow ({cfg.nfft}//2+1)={cfg.freq_bins} frequency bins")
    print(f"\tFeatures shape: {feature.shape}")
