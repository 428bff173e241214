"""Event-based evaluation: onset/offset-matched precision/recall/F-score
(counterpart of ``sed_tpu.utils.event_metrics``).

The reference evaluates only at the FRAME level (utils/metric_utils.py:4-37,
reproduced exactly in sed_tpu/utils/metrics.py).  For an event detector the
community-standard complement is the DCASE event-based measure (sed_eval's
"event-based metrics", Mesaros et al. 2016): a predicted event counts as a
true positive when its onset lies within a collar of a ground-truth onset
and, optionally, its offset within ``max(collar, offset_ratio * gt_length)``
of the ground-truth offset; each ground-truth event may be matched at most
once.

This evaluates the full serving pipeline — scores through
``events_post.extract_events`` — on the quantity users of the FilmClap
use-case actually consume (event times, reference dataset_utils.py:13-39),
rather than per-frame paint.

Pure NumPy on host: the event lists are tiny; this has no business on the
accelerator.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]  # (start_sec, end_sec)


def match_events(
    ref: Sequence[Interval],
    est: Sequence[Interval],
    onset_collar: float = 0.2,
    offset_collar: float = 0.2,
    offset_ratio: float = 0.2,
    match_offset: bool = True,
) -> List[Tuple[int, int]]:
    """MAXIMUM bipartite matching of estimated to reference events.

    An (est, ref) pair is compatible when ``|est_on - ref_on| <=
    onset_collar`` and, if ``match_offset``, ``|est_off - ref_off| <=
    max(offset_collar, offset_ratio * ref_length)`` (sed_eval's onset/offset
    conditions).  sed_eval computes the TP count as the maximum-cardinality
    matching of the compatibility (hit) matrix — its util.bipartite_match —
    not a greedy first-fit, and so does this (Kuhn augmenting paths; same
    cardinality as sed_eval's Hopcroft–Karp).  The greedy matcher this
    replaced could under-count TPs when an early estimate grabbed the only
    reference a later estimate fit (round-5 oracle fuzz,
    tests/test_event_metrics_oracle.py, pins equality against a literal
    port of sed_eval's published algorithm).  Returns matched index pairs
    ``(est_idx, ref_idx)``, est-onset-ordered.
    """
    est_order = sorted(range(len(est)), key=lambda i: est[i][0])

    # The compatibility (hit) matrix in float64, as sed_tpu's scalar tests
    # compute it; each estimate's compatible references ascending.
    e = np.asarray(est, np.float64).reshape(-1, 2)
    r = np.asarray(ref, np.float64).reshape(-1, 2)
    hit = np.abs(e[:, None, 0] - r[None, :, 0]) <= onset_collar
    if match_offset:
        tol = np.maximum(offset_collar, offset_ratio * (r[:, 1] - r[:, 0]))
        hit &= np.abs(e[:, None, 1] - r[None, :, 1]) <= tol[None, :]
    comp = {ei: np.flatnonzero(hit[ei]).tolist() for ei in est_order}
    match_ref: Dict[int, int] = {}  # ref idx -> est idx
    for ei in est_order:
        _augment(ei, comp, match_ref)
    pairs = [(ei, ri) for ri, ei in match_ref.items()]
    pairs.sort(key=lambda p: (est[p[0]][0], p[0]))
    return pairs


def _augment(root: int, comp: Dict[int, List[int]], match_ref: Dict[int, int]) -> bool:
    """One augmenting-path search from estimate ``root`` (Kuhn's algorithm).

    Divergence from ``sed_tpu``, whose ``try_assign`` recurses once per
    level of the path: the path here is an explicit stack, so ~1000 or more
    mutually compatible events no longer raise ``RecursionError``.  The
    search visits the same references in the same order (each estimate's
    compatible references ascending, a reference tried at most once per
    search) and so returns the same pairs.  ``first_unseen`` (union-find
    over reference indices) skips the references already tried in one step,
    so a dense hit matrix costs O(path length) per search, not its square.
    """
    skip: Dict[int, int] = {}  # tried ref -> a later ref index to look from

    def first_unseen(ri: int) -> int:
        root_ri = ri
        while root_ri in skip:
            root_ri = skip[root_ri]
        while ri != root_ri:  # path compression
            skip[ri], ri = root_ri, skip[ri]
        return root_ri

    stack = [[root, 0]]  # [estimate, next position in its comp list]
    through: List[Tuple[int, int]] = []  # (estimate, ref) of each descent
    while stack:
        frame = stack[-1]
        ei, pos = frame
        options = comp[ei]
        ri = None
        while pos < len(options):
            cand = first_unseen(options[pos])
            if cand == options[pos]:
                ri = cand
                break
            pos = bisect.bisect_left(options, cand, pos)
        if ri is None:  # no untried reference: back to the estimate below
            stack.pop()
            if through:
                through.pop()
            continue
        frame[1] = pos + 1
        skip[ri] = ri + 1
        if ri not in match_ref:  # a free reference ends the path
            match_ref[ri] = ei
            for e, r in reversed(through):
                match_ref[r] = e
            return True
        through.append((ei, ri))
        stack.append([match_ref[ri], 0])
    return False


def event_based_metrics(
    ref: Sequence[Interval],
    est: Sequence[Interval],
    onset_collar: float = 0.2,
    offset_collar: float = 0.2,
    offset_ratio: float = 0.2,
    match_offset: bool = True,
) -> Dict[str, float]:
    """Event-based P/R/F1 for one class of one (or one pooled) recording.

    Degenerate conventions follow the house frame-metric style
    (utils/metrics.py; reference metric_utils.py:30-31): recall := 1 when
    there are no reference events, precision := 1 when there are no
    estimated events.
    """
    pairs = match_events(ref, est, onset_collar, offset_collar,
                         offset_ratio, match_offset)
    tp = len(pairs)
    return _pooled({"tp": tp, "fp": len(est) - tp, "fn": len(ref) - tp})


def event_metrics_from_scores(
    scores: np.ndarray,
    ref_start_times: Sequence[float],
    ref_end_times: Sequence[float],
    frames_per_second: float,
    threshold: float = 0.5,
    min_duration: float = 0.0,
    merge_gap: float = 0.0,
    onset_collar: float = 0.2,
    offset_collar: float = 0.2,
    offset_ratio: float = 0.2,
    match_offset: bool = True,
    class_index: int = 0,
) -> Dict[str, float]:
    """End-to-end: ``(frames, classes)`` sigmoid scores + ground-truth event
    times (the parser format of io/tau.py / io/film_clap.py) -> event-based
    metrics for ``class_index``, with extraction via
    events_post.extract_events."""
    from sed_tpu_torch.utils.events_post import extract_events

    est_full = extract_events(np.asarray(scores), frames_per_second,
                              threshold=threshold, min_duration=min_duration,
                              merge_gap=merge_gap)[class_index]
    est = [(s, e) for s, e, _ in est_full]
    ref = list(zip(ref_start_times, ref_end_times))
    return event_based_metrics(ref, est, onset_collar, offset_collar,
                               offset_ratio, match_offset)


def event_metrics_from_matrices(
    scores: np.ndarray,
    event_matrix: np.ndarray,
    frames_per_second: float,
    threshold: float = 0.5,
    onset_collar: float | None = None,
    **kwargs,
) -> Dict[str, float]:
    """Micro-averaged event metrics from ``(frames, classes)`` scores and a
    rasterized 0/1 ground-truth matrix (data/events.py create_event_matrix
    output — what the eval loop's validation sampler yields).

    Ground-truth intervals are recovered from the matrix runs, so onsets are
    quantized to the frame grid; ``onset_collar`` therefore defaults to one
    frame period (1/fps — larger than the DCASE 0.2 s at the reference's
    3 fps) instead of the raw-times default.
    """
    per_class = _event_counts_per_class(scores, event_matrix, frames_per_second,
                                        threshold, onset_collar, **kwargs)
    return _pooled({k: sum(m[k] for m in per_class) for k in ("tp", "fp", "fn")})


def _event_counts_per_class(scores, event_matrix, frames_per_second,
                            threshold=0.5, onset_collar=None, **kwargs):
    """Per-class event tp/fp/fn dicts — the ONE extraction+matching pass
    shared by the micro (pooled) and per-class/macro views."""
    from sed_tpu_torch.utils.events_post import _runs, extract_events

    scores = np.asarray(scores)
    gt = np.asarray(event_matrix)
    if gt.shape != scores.shape:
        raise ValueError(f"shape mismatch: scores {scores.shape} vs "
                         f"event matrix {gt.shape}")
    fps = float(frames_per_second)
    collar = (1.0 / fps) if onset_collar is None else onset_collar
    kwargs.setdefault("offset_collar", collar)
    est_all = extract_events(scores, fps, threshold=threshold)
    out = []
    for c in range(scores.shape[1]):
        ref = [(s / fps, e / fps) for s, e in _runs(gt[:, c] >= 0.5)]
        est = [(s, e) for s, e, _ in est_all[c]]
        out.append(event_based_metrics(ref, est, onset_collar=collar, **kwargs))
    return out


def event_metrics_per_class_from_matrices(
    scores: np.ndarray,
    event_matrix: np.ndarray,
    frames_per_second: float,
    threshold: float = 0.5,
    onset_collar: float | None = None,
    **kwargs,
) -> List[Dict[str, float]]:
    """Class-wise event-based metrics (sed_eval's class-wise view): one
    P/R/F1 dict per class column.  Macro-average across recordings and
    classes with :func:`macro_average_classes`."""
    return _event_counts_per_class(scores, event_matrix, frames_per_second,
                                   threshold, onset_collar, **kwargs)


def _pooled(tot: Dict[str, int]) -> Dict[str, float]:
    """tp/fp/fn counts -> P/R/F1 under the house degenerate conventions
    (precision := 1 when nothing was estimated, recall := 1 when there is
    no ground truth) — THE one definition shared by event_based_metrics,
    event_metrics_from_matrices, and micro_average."""
    n_ref = tot["tp"] + tot["fn"]
    n_est = tot["tp"] + tot["fp"]
    precision = tot["tp"] / n_est if n_est else 1.0
    recall = tot["tp"] / n_ref if n_ref else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {**tot, "precision": precision, "recall": recall, "f1": f1}


def micro_average(metrics: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Pool per-recording event-metric dicts into one micro-averaged dict
    (sum tp/fp/fn, recompute P/R/F1).  Used by the train loop to put ONE
    event-level row per log point into metrics.jsonl."""
    return _pooled({k: int(sum(m[k] for m in metrics))
                    for k in ("tp", "fp", "fn")})


# ---------------------------------------------------------------------------
# Segment-based metrics (sed_eval's third standard view, Mesaros et al. 2016):
# time is cut into fixed-length segments; a class is active in a segment when
# ANY of its frames is active there.  Complements the frame metrics (the
# reference's own view, utils/metric_utils.py:4-37) and the event-based
# collar metrics above — segment F1/ER is the headline measure of the DCASE
# SED task family the TAU dataset comes from.
# ---------------------------------------------------------------------------


def segment_activity(matrix: np.ndarray, frames_per_second: float,
                     segment_length: float = 1.0) -> np.ndarray:
    """(frames, classes) 0/1 activity -> (segments, classes) bool; a segment
    is active when any of its frames is (frame f belongs to segment
    ``floor(f / fps / segment_length)``)."""
    act = np.asarray(matrix) >= 0.5
    n_frames, n_classes = act.shape
    idx = np.floor(np.arange(n_frames) / float(frames_per_second)
                   / segment_length).astype(np.int64)
    n_seg = int(idx[-1]) + 1 if n_frames else 0
    out = np.zeros((n_seg, n_classes), dtype=bool)
    for c in range(n_classes):
        np.logical_or.at(out[:, c], idx, act[:, c])
    return out


def segment_metrics_from_matrices(
    scores: np.ndarray,
    event_matrix: np.ndarray,
    frames_per_second: float,
    threshold: float = 0.5,
    segment_length: float = 1.0,
) -> Dict[str, float]:
    """Segment-based P/R/F1 + error rate from ``(frames, classes)`` sigmoid
    scores and a rasterized ground-truth matrix.

    ER follows sed_eval: per segment, with ``fn_s``/``fp_s`` the per-class
    miss/false-alarm counts in that segment, substitutions
    ``S = min(fn_s, fp_s)``, deletions ``D = fn_s - S``, insertions
    ``I = fp_s - S``; ``ER = (ΣS + ΣD + ΣI) / Σ n_ref``.  P/R/F1 pool
    tp/fp/fn over all segments and classes under the house degenerate
    conventions (_pooled)."""
    scores = np.asarray(scores)
    gt = np.asarray(event_matrix)
    if gt.shape != scores.shape:
        raise ValueError(f"shape mismatch: scores {scores.shape} vs "
                         f"event matrix {gt.shape}")
    est = segment_activity(scores >= threshold, frames_per_second,
                           segment_length)
    ref = segment_activity(gt, frames_per_second, segment_length)
    tp = int(np.sum(est & ref))
    fp_s = np.sum(est & ~ref, axis=1)  # per-segment false alarms
    fn_s = np.sum(~est & ref, axis=1)  # per-segment misses
    s = np.minimum(fn_s, fp_s)
    out = _pooled({"tp": tp, "fp": int(fp_s.sum()), "fn": int(fn_s.sum())})
    out["substitutions"] = int(s.sum())
    out["deletions"] = int((fn_s - s).sum())
    out["insertions"] = int((fp_s - s).sum())
    out["n_ref"] = int(ref.sum())
    out["error_rate"] = _segment_er(out)
    return out


def _segment_er(tot: Dict[str, float]) -> float:
    """ER = (S + D + I) / N_ref; := 0 when there is no reference activity
    and nothing was inserted, else insertions count against an empty
    reference as ER = inf convention is avoided by reporting the raw sum
    (sed_eval reports inf; a serving log can't carry inf, so an empty
    reference with insertions reports the insertion count)."""
    n_ref = tot["n_ref"]
    sdi = tot["substitutions"] + tot["deletions"] + tot["insertions"]
    if n_ref == 0:
        return float(sdi)
    return sdi / n_ref


def segment_metrics_per_class_from_matrices(
    scores: np.ndarray,
    event_matrix: np.ndarray,
    frames_per_second: float,
    threshold: float = 0.5,
    segment_length: float = 1.0,
) -> List[Dict[str, float]]:
    """Class-wise segment-based metrics: one P/R/F1 + ER dict per class.

    Class-wise ER follows sed_eval's class-wise convention — with a single
    class there are no substitutions, so ``ER_c = (fn_c + fp_c) / n_ref_c``
    (deletions + insertions over that class's reference segments).
    """
    scores = np.asarray(scores)
    gt = np.asarray(event_matrix)
    if gt.shape != scores.shape:
        raise ValueError(f"shape mismatch: scores {scores.shape} vs "
                         f"event matrix {gt.shape}")
    est = segment_activity(scores >= threshold, frames_per_second, segment_length)
    ref = segment_activity(gt, frames_per_second, segment_length)
    out = []
    for c in range(scores.shape[1]):
        tp = int(np.sum(est[:, c] & ref[:, c]))
        fp = int(np.sum(est[:, c] & ~ref[:, c]))
        fn = int(np.sum(~est[:, c] & ref[:, c]))
        m = _pooled({"tp": tp, "fp": fp, "fn": fn})
        m["n_ref"] = tp + fn
        m["error_rate"] = (fn + fp) / (tp + fn) if tp + fn else float(fp)
        out.append(m)
    return out


def macro_average_classes(
    per_recording_per_class: Sequence[Sequence[Dict[str, float]]],
) -> Dict[str, float]:
    """Macro averaging over classes, pooled over recordings (sed_eval's
    class-wise average): per class, sum tp/fp/fn across recordings and
    compute P/R/F1 (house degenerate conventions); the macro numbers are the
    unweighted class means.

    Input: for each recording, the list of per-class dicts
    (:func:`event_metrics_per_class_from_matrices` /
    :func:`segment_metrics_per_class_from_matrices` output).  Returns
    ``{"per_class": [C class dicts], "precision", "recall", "f1"}``.
    """
    if not per_recording_per_class:
        return {"per_class": [], "precision": 1.0, "recall": 1.0, "f1": 0.0}
    n_classes = len(per_recording_per_class[0])
    per_class = []
    for c in range(n_classes):
        per_class.append(_pooled({
            k: int(sum(rec[c][k] for rec in per_recording_per_class))
            for k in ("tp", "fp", "fn")
        }))
    return {
        "per_class": per_class,
        "precision": float(np.mean([m["precision"] for m in per_class])),
        "recall": float(np.mean([m["recall"] for m in per_class])),
        "f1": float(np.mean([m["f1"] for m in per_class])),
    }


def micro_average_segments(metrics: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Pool per-recording segment-metric dicts (sum all counts, recompute
    P/R/F1 and ER) — the segment analog of :func:`micro_average`."""
    keys = ("tp", "fp", "fn", "substitutions", "deletions", "insertions",
            "n_ref")
    tot = {k: int(sum(m[k] for m in metrics)) for k in keys}
    out = _pooled({k: tot[k] for k in ("tp", "fp", "fn")})
    out.update({k: tot[k] for k in keys if k not in ("tp", "fp", "fn")})
    out["error_rate"] = _segment_er(out)
    return out
