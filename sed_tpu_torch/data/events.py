"""Event-label rasterization: (start, end) second intervals -> frame/sample grids
(counterpart of ``sed_tpu.data.events``, the port's own numpy copy).

Vectorized re-implementations of the reference's per-event Python loops:
  * :func:`create_event_matrix`        (reference: dataset/spectogram/spectograms_dataset.py:205-218)
  * :func:`start_index_labels`         (reference: dataset/waveform/waveform_dataset.py:33-43)
  * :func:`frame_coverage_labels`      (reference: dataset/waveform/waveform_dataset.py:10-30)
"""

from __future__ import annotations

import numpy as np

from sed_tpu_torch.configs import DEFAULT_AUDIO, AudioConfig


def create_event_matrix(
    frames_num: int,
    start_times,
    end_times,
    cfg: AudioConfig = DEFAULT_AUDIO,
    class_indices=None,
) -> np.ndarray:
    """Per-frame classification matrix: 1 inside events, 0 elsewhere.

    Frame grid matches the reference exactly (spectograms_dataset.py:205-218):
      start_frame = round(start * fps); end_frame = round(end * fps) + 1.

    ``class_indices=None`` reproduces the reference's class-blind painting —
    every event paints *all* class columns (spectograms_dataset.py:217), which
    is only correct while classes_num == 1.  With per-event ``class_indices``
    (the TAU parser's LabeledAudio attribute), each event paints only its own
    column — the deliberate divergence that makes classes_num > 1 meaningful
    (PARITY.md "Known divergences"; for classes_num == 1 the two paths are
    identical).
    """
    event_matrix = np.zeros((frames_num, cfg.classes_num), dtype=np.float32)
    starts = np.asarray(start_times, dtype=np.float64)
    ends = np.asarray(end_times, dtype=np.float64)
    if starts.size == 0:
        return event_matrix

    fps = cfg.frames_per_second
    start_frames = np.round(starts * fps).astype(np.int64)
    end_frames = np.round(ends * fps).astype(np.int64) + 1
    start_frames = np.clip(start_frames, 0, frames_num)
    end_frames = np.clip(end_frames, 0, frames_num)

    # Difference-array trick instead of a per-event Python loop: +1 at each
    # start, -1 after each end, cumsum, then threshold (events may overlap).
    if class_indices is None:
        diff = np.zeros(frames_num + 1, dtype=np.int64)
        np.add.at(diff, start_frames, 1)
        np.add.at(diff, end_frames, -1)
        event_matrix[np.cumsum(diff[:-1]) > 0] = 1.0
    else:
        cls = np.asarray(class_indices, dtype=np.int64)
        if cls.shape != starts.shape:
            raise ValueError(
                f"class_indices shape {cls.shape} does not match "
                f"{starts.shape[0]} events"
            )
        if cls.size and (cls.min() < 0 or cls.max() >= cfg.classes_num):
            raise ValueError(
                f"class index out of range for classes_num={cfg.classes_num}"
            )
        diff = np.zeros((frames_num + 1, cfg.classes_num), dtype=np.int64)
        np.add.at(diff, (start_frames, cls), 1)
        np.add.at(diff, (end_frames, cls), -1)
        event_matrix[np.cumsum(diff[:-1], axis=0) > 0] = 1.0
    return event_matrix


def start_index_labels(
    waveform_length: int,
    start_times,
    end_times,
    cfg: AudioConfig = DEFAULT_AUDIO,
    class_indices=None,
) -> np.ndarray:
    """Per-sample boolean array: is a frame *starting* at sample i >=74% event-covered.

    Matches the analytic rule of the reference (waveform_dataset.py:33-43):
    for each event [s, e) seconds, start indices in
      [s*fs - frame*(1-p), e*fs - frame*p)
    are positive, where p = min_event_percentage_in_positive_frame.

    With ``class_indices`` the result is ``(waveform_length, classes_num)``
    and each event marks only its own class column (the multiclass divergence,
    see :func:`create_event_matrix`); without, the reference's class-blind
    1-D array.
    """
    multiclass = class_indices is not None
    if multiclass:
        label = np.zeros((waveform_length, cfg.classes_num), dtype=bool)
        cls = np.asarray(class_indices, dtype=np.int64)
    else:
        label = np.zeros(waveform_length, dtype=bool)
        cls = np.zeros(len(np.atleast_1d(np.asarray(start_times))), dtype=np.int64)
    fs = cfg.working_sample_rate
    frame = cfg.frame_size
    p = cfg.min_event_percentage_in_positive_frame
    for start, end, c in zip(np.asarray(start_times), np.asarray(end_times), cls):
        first = int(start * fs - frame * (1 - p))
        last = int(end * fs - frame * p)
        # Guard against negative python-slice wraparound; the reference's raw
        # slice assignment behaves the same for in-range events.
        first = max(first, 0)
        if last > first:
            sl = slice(first, min(last, waveform_length))
            if multiclass:
                label[sl, c] = True
            else:
                label[sl] = True
    return label


def frame_coverage_labels(
    waveform: np.ndarray,
    start_times,
    end_times,
    cfg: AudioConfig = DEFAULT_AUDIO,
    class_indices=None,
):
    """Split (channels, samples) into hop-strided frames + coverage labels.

    Matches the reference's validation-frame splitter
    (waveform_dataset.py:10-30): centers run from frame//2 to
    samples - frame//2 (inclusive) with step hop; a frame is positive iff any
    single event covers more than ``min_event_percentage_in_positive_frame``
    of it.

    Returns (frames, labels): frames is (n_frames, channels, frame_size)
    float32, labels is (n_frames,) bool — or (n_frames, classes_num) with
    per-event ``class_indices`` (the multiclass divergence; each event then
    labels only its own class column).
    """
    channels, samples = waveform.shape
    half = cfg.frame_size // 2
    centers = np.arange(half, samples - half + 1, step=cfg.hop_size)
    n = len(centers)
    # Width 2*half, matching the reference's center-half:center+half slices
    # (equals frame_size for even sizes; avoids a broadcast crash for odd).
    frames = np.empty((n, channels, 2 * half), dtype=waveform.dtype)
    for i, c in enumerate(centers):
        frames[i] = waveform[:, c - half:c + half]

    multiclass = class_indices is not None
    labels = np.zeros((n, cfg.classes_num) if multiclass else n, dtype=bool)
    fs = cfg.working_sample_rate
    starts = np.asarray(start_times, dtype=np.float64) * fs
    ends = np.asarray(end_times, dtype=np.float64) * fs
    if starts.size:
        lo = np.maximum(starts[None, :], (centers - half)[:, None])
        hi = np.minimum(ends[None, :], (centers + half)[:, None])
        covered = (hi - lo) / cfg.frame_size \
            > cfg.min_event_percentage_in_positive_frame  # (n_frames, n_events)
        if multiclass:
            cls = np.asarray(class_indices, dtype=np.int64)
            for c in range(cfg.classes_num):
                if np.any(cls == c):
                    labels[:, c] = covered[:, cls == c].any(axis=1)
        else:
            labels = covered.any(axis=1)
    return frames, labels
