"""Score post-processing: per-frame sigmoid confidences -> event intervals
(counterpart of ``sed_tpu.utils.events_post``).

Threshold the frame scores, merge nearby runs, drop too-short blips, and
report (start_s, end_s, peak) intervals per class.  Pure NumPy on the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Event = Tuple[float, float, float]  # (start_sec, end_sec, peak_score)


def _runs(mask: np.ndarray) -> np.ndarray:
    """Contiguous True runs of a 1-D bool mask as an (n, 2) array of
    [start, end) frame indices."""
    if not mask.any():
        return np.zeros((0, 2), np.int64)
    d = np.diff(mask.astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return np.stack([starts, ends], axis=1)


def extract_events(
    scores: np.ndarray,
    frames_per_second: float,
    threshold: float = 0.5,
    min_duration: float = 0.0,
    merge_gap: float = 0.0,
) -> List[List[Event]]:
    """Per-class event intervals from ``(frames, classes)`` sigmoid scores.

    A frame is active when ``score >= threshold``.  Runs separated by less
    than ``merge_gap`` seconds are merged (the gap counts as part of the
    event); merged runs shorter than ``min_duration`` seconds are dropped.
    Returns one list of ``(start_sec, end_sec, peak_score)`` per class;
    ``end_sec`` is exclusive (first inactive frame / fps).
    """
    scores = np.asarray(scores)
    if scores.ndim != 2:
        raise ValueError(f"scores must be (frames, classes), got {scores.shape}")
    if not 0.0 < threshold <= 1.0:
        raise ValueError(f"threshold must be in (0, 1], got {threshold}")
    fps = float(frames_per_second)
    out: List[List[Event]] = []
    for c in range(scores.shape[1]):
        col = scores[:, c]
        merged: List[List[int]] = []
        for s, e in _runs(col >= threshold):
            if merged and (s - merged[-1][1]) / fps < merge_gap:
                merged[-1][1] = int(e)
            else:
                merged.append([int(s), int(e)])
        out.append([(s / fps, e / fps, float(col[s:e].max()))
                    for s, e in merged if (e - s) / fps >= min_duration])
    return out


def events_to_csv(
    events: Sequence[Sequence[Event]],
    class_names: Sequence[str],
    path: str,
) -> None:
    """Write extract_events output as ``class,start_sec,end_sec,peak`` rows."""
    with open(path, "w") as f:
        f.write("class,start_sec,end_sec,peak\n")
        for name, evs in zip(class_names, events):
            for s, e, p in evs:
                f.write(f"{name},{s:.3f},{e:.3f},{p:.6f}\n")
