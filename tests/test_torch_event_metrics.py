"""The port's frame, event and segment metrics and ProgressPlotter against
sed_tpu's, on the CPU.

Every public name of ``utils/event_metrics.py`` and ``utils/metrics.py`` on
the fuzz trials of tests/test_event_metrics_oracle.py (the same draws):
counts, dicts and matched pairs identical, frame metrics equal to float64
rounding (atol 1e-12), the torch sweep within 1e-6 of the numpy one.  R1:
the port's matcher is an explicit-stack augmenting-path search, so 2,000
mutually compatible events match (sed_tpu's recursion raises there).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.utils import event_metrics as jem
from sed_tpu.utils import metrics as jmetrics
from sed_tpu_torch.utils import event_metrics as em
from sed_tpu_torch.utils import metrics


def _random_events(rng, n, spread, min_len=0.05, max_len=2.0):
    """Event lists with clustered onsets (tests/test_event_metrics_oracle.py)."""
    onsets = np.round(rng.uniform(0, spread, n), 3)
    lengths = np.round(rng.uniform(min_len, max_len, n), 3)
    return [(float(s), float(s + l)) for s, l in zip(onsets, lengths)]


@pytest.mark.parametrize("evaluate_offset", [True, False])
def test_event_matching_matches_sed_tpu_on_oracle_trials(evaluate_offset):
    rng = np.random.default_rng(0 if evaluate_offset else 1)
    for trial in range(400):
        n_ref = int(rng.integers(0, 7))
        n_est = int(rng.integers(0, 7))
        spread = float(rng.uniform(0.1, 3.0))
        collar = float(rng.uniform(0.05, 0.5))
        ratio = float(rng.choice([0.2, 0.5, 1.0]))
        ref = _random_events(rng, n_ref, spread)
        est = _random_events(rng, n_est, spread)
        args = (ref, est, collar, collar, ratio, evaluate_offset)
        assert em.match_events(*args) == jem.match_events(*args), f"trial {trial}"
        assert em.event_based_metrics(*args) == jem.event_based_metrics(*args), f"trial {trial}"


@pytest.mark.parametrize("n", [12, 60, 200])
def test_dense_matching_matches_sed_tpu(n):
    """Larger hit matrices (long augmenting paths) within sed_tpu's
    recursion limit: the same pairs."""
    rng = np.random.default_rng(n)
    ref = _random_events(rng, n, 0.3, 0.5, 0.7)
    est = _random_events(rng, n + 3, 0.3, 0.5, 0.7)
    assert em.match_events(ref, est) == jem.match_events(ref, est)
    same = [(0.0, 1.0)] * n
    assert em.match_events(same, same) == jem.match_events(same, same)


def test_r1_thousands_of_compatible_events_match():
    n = 2000
    events = [(0.001 * (i % 7), 1.0) for i in range(n)]
    pairs = em.match_events(events, events)
    assert len(pairs) == n
    assert sorted(e for e, _ in pairs) == list(range(n))
    assert sorted(r for _, r in pairs) == list(range(n))
    assert em.event_based_metrics(events, events)["f1"] == 1.0


def test_match_events_maximum_not_greedy():
    ref = [(0.0, 1.0), (0.1, 1.4)]
    est = [(0.02, 1.1), (0.0, 1.2)]
    assert sorted(em.match_events(ref, est, 0.2, 0.2, 0.2, True)) == [(0, 0), (1, 1)]


@pytest.mark.parametrize("seed", range(4))
def test_matrix_and_score_metrics_match_sed_tpu(seed):
    rng = np.random.default_rng(seed)
    n_frames, n_classes = int(rng.integers(5, 80)), int(rng.integers(1, 4))
    fps = float(rng.choice([1.0, 3.0, 10.0]))
    scores = rng.random((n_frames, n_classes)).astype(np.float32)
    gt = (rng.random((n_frames, n_classes)) < 0.3).astype(np.float32)
    for fn in ("event_metrics_from_matrices", "event_metrics_per_class_from_matrices",
               "segment_metrics_from_matrices", "segment_metrics_per_class_from_matrices"):
        assert getattr(em, fn)(scores, gt, fps) == getattr(jem, fn)(scores, gt, fps), fn
    seg = float(rng.choice([0.5, 1.0, 2.0]))
    np.testing.assert_array_equal(em.segment_activity(gt, fps, seg),
                                  jem.segment_activity(gt, fps, seg))
    starts = np.sort(rng.uniform(0, n_frames / fps, 3))
    ends = starts + rng.uniform(0.2, 2.0, 3)
    for c in range(n_classes):
        kw = dict(threshold=0.4, min_duration=0.1, merge_gap=0.2, class_index=c)
        assert em.event_metrics_from_scores(scores, starts, ends, fps, **kw) == \
            jem.event_metrics_from_scores(scores, starts, ends, fps, **kw)


def test_averages_match_sed_tpu():
    rng = np.random.default_rng(9)
    recs = []
    for _ in range(5):
        scores = rng.random((40, 2)).astype(np.float32)
        gt = (rng.random((40, 2)) < 0.3).astype(np.float32)
        recs.append((scores, gt))
    ev = [em.event_metrics_from_matrices(s, g, 3.0) for s, g in recs]
    per = [em.event_metrics_per_class_from_matrices(s, g, 3.0) for s, g in recs]
    seg = [em.segment_metrics_from_matrices(s, g, 3.0) for s, g in recs]
    seg_per = [em.segment_metrics_per_class_from_matrices(s, g, 3.0) for s, g in recs]
    assert em.micro_average(ev) == jem.micro_average(ev)
    assert em.micro_average_segments(seg) == jem.micro_average_segments(seg)
    assert em.macro_average_classes(per) == jem.macro_average_classes(per)
    assert em.macro_average_classes(seg_per) == jem.macro_average_classes(seg_per)
    assert em.macro_average_classes([]) == jem.macro_average_classes([])


@pytest.mark.parametrize("seed", range(4))
def test_frame_metrics_match_sed_tpu(seed):
    rng = np.random.default_rng(seed)
    out = rng.random((int(rng.integers(3, 90)), 2)).astype(np.float32)
    tgt = (rng.random((out.shape[0] + int(rng.integers(0, 3)), 2)) < 0.3).astype(np.float32)
    for a, b in zip(metrics.calculate_metrics(out, tgt), jmetrics.calculate_metrics(out, tgt)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for a, b in zip(metrics.calculate_metrics_per_class(out, tgt),
                    jmetrics.calculate_metrics_per_class(out, tgt)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    hard = (out > 0.5).astype(np.float32)
    assert metrics.compute_recall_precision(hard, tgt[:len(out)]) == \
        jmetrics.compute_recall_precision(hard, tgt[:len(out)])
    r, p = rng.random(21), rng.random(21)
    for beta in (1.0, 5.0):
        np.testing.assert_array_equal(metrics.f_score(r, p, beta), jmetrics.f_score(r, p, beta))
    # The device sweep, batched over recordings, against sed_tpu's jax one.
    n = out.shape[0]
    batch_out = np.stack([out, out[::-1].copy()])
    batch_tgt = np.stack([tgt[:n], tgt[:n][::-1].copy()])
    got = metrics.calculate_metrics_torch(torch.from_numpy(batch_out),
                                          torch.from_numpy(batch_tgt))
    for i in range(2):
        want = jmetrics.calculate_metrics_jax(jnp.asarray(batch_out[i]),
                                              jnp.asarray(batch_tgt[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=1e-6)


def test_frame_metrics_degenerate_conventions():
    none = np.zeros((10, 1), np.float32)
    r, p, ap = metrics.calculate_metrics(none, none)
    jr, jp, jap = jmetrics.calculate_metrics(none, none)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(p, jp)
    assert ap == jap
    tr, tp, tap = metrics.calculate_metrics_torch(torch.zeros(10, 1), torch.zeros(10, 1))
    np.testing.assert_allclose(tr.numpy(), r, atol=1e-7)
    np.testing.assert_allclose(tp.numpy(), p, atol=1e-7)


def test_progress_records_match_sed_tpu(tmp_path):
    """Both plotters fed the same reports write the same metrics.jsonl."""
    from sed_tpu.utils.progress import ProgressPlotter as JaxPlotter
    from sed_tpu_torch.utils.progress import ProgressPlotter

    rng = np.random.default_rng(3)
    lines = []
    for tag, cls in (("torch", ProgressPlotter), ("jax", JaxPlotter)):
        plotter = cls()
        for it in (5, 10):
            for v in rng.random(3):
                plotter.report_train_loss(v)
            plotter.report_validation_metrics([0.5, 0.25], [np.linspace(1, 0, 21)] * 2,
                                              [np.linspace(0.2, 1, 21)] * 2, [0.3, 0.4], it)
            plotter.report_event_metrics({"tp": 1, "fp": 2, "fn": 0, "precision": 1 / 3,
                                          "recall": 1.0, "f1": 0.5, "per_class": [{}]})
            plotter.report_segment_metrics({"tp": 3, "error_rate": 0.5})
            plotter.report_per_class_metrics([0.3, 0.5], {"precision": 0.1, "recall": 0.2,
                                                          "f1": 0.3},
                                             {"precision": 0.4, "recall": 0.5, "f1": 0.6})
            plotter.record(str(tmp_path / tag))
        rng = np.random.default_rng(3)
        with open(tmp_path / tag / "metrics.jsonl") as f:
            lines.append([json.loads(line) for line in f])
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert not list((tmp_path / "torch").glob("*.png"))


def test_progress_plots_need_matplotlib_only_to_draw(tmp_path):
    import sys

    from sed_tpu_torch.utils import progress

    assert "matplotlib" not in progress.__dict__
    pytest.importorskip("matplotlib")
    plotter = progress.ProgressPlotter()
    plotter.report_train_loss(1.0)
    plotter.report_validation_metrics([0.5], [np.linspace(1, 0, 21)],
                                      [np.linspace(0.2, 1, 21)], [0.3], 3)
    plotter.record(str(tmp_path))
    plotter.plot(str(tmp_path))
    assert {p.name for p in tmp_path.glob("*.png")} == {"Training_loss.png", "Metrics.png"}
    assert (tmp_path / "ROC_plots" / "Roc-iteration-3.png").exists()
    assert "matplotlib" in sys.modules
