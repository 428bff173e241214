"""The SVM baseline of the port (``sed_tpu_torch.classical``) against
``sed_tpu.classical.svm`` and scikit-learn, on the CPU in float64.

Bounds:
  * ``featurize_frames``: within 1e-4 dB of ``sed_tpu``'s;
  * the solver at ``tol=1e-8`` against ``SVC(tol=1e-8)`` with the same
    gamma and weights: decision values within 1e-5, the same support set
    (libsvm keeps its kernel cache in float32, the port computes in float64;
    measured 3.3e-7);
  * at the default ``tol=1e-3``: the hard labels agree with ``sed_tpu``'s
    ``SVMDetector`` on >= 99% of rows and the decision values lie within
    ``DEC_GAP_1E3`` = 1e-3 (the stopping tolerance) of scikit-learn's; on
    these problems the two make the same iterations and the gap measures
    ~3e-7;
  * a fitted ``sed_tpu`` detector carried by ``from_sklearn_arrays``:
    ``decision_function`` and ``predict_proba`` within 1e-8;
  * ``sigmoid_train``: A and B within 1e-4 of
    ``sklearn.calibration._sigmoid_calibration`` on the same values;
  * soft scores: AP within 0.5 points of ``sed_tpu``'s (BASELINE's budget;
    the probability fits draw different folds).
"""

import pickle
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu.classical import svm as jax_svm
from sed_tpu.configs import WaveformConfig as JaxWaveformConfig
from sed_tpu.io.film_clap import get_film_clap_paths_and_labels as jax_film_clap
from sed_tpu_torch.classical import svc, svm
from sed_tpu_torch.configs import DEFAULT_WAVEFORM, WaveformConfig
from sed_tpu_torch.io.film_clap import LABEL_FILE, get_film_clap_paths_and_labels
from sed_tpu_torch.utils.metrics import calculate_metrics

WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
JWCFG = JaxWaveformConfig(working_sample_rate=8000, time_margin=0.33)
DB_TOL = 1e-4
DEC_GAP_1E3 = 1e-3
AP_BUDGET = 0.005


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problem(n=400, d=16, seed=0, rp=10.0):
    """Seeded rows with a curved boundary and label noise; labels 0/1 and
    the recall-priority weights label * rp + (1 - label)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.7 * rng.standard_normal(n) > 1.0).astype(float)
    return x, y, y * rp + (1 - y)


def sklearn_svc(**kw):
    from sklearn.svm import SVC

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return SVC(C=1, kernel="rbf", gamma="scale", **kw)


# ---- the featurizer ---------------------------------------------------------------


@pytest.mark.parametrize("cfg,jcfg,rows", [(WCFG, JWCFG, 6), (DEFAULT_WAVEFORM, None, 3)],
                         ids=["8k", "48k"])
def test_featurize_frames_matches_sed_tpu(cfg, jcfg, rows):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((rows, cfg.frame_size))
    frames[0] *= 1e-4
    got = svm.featurize_frames(frames, cfg, device="cpu")
    want = np.asarray(jax_svm.featurize_frames(frames, jcfg or JaxWaveformConfig()))
    assert got.shape == want.shape == (rows, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_TOL)


def test_featurize_frames_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svm.featurize_frames(np.zeros((1, WCFG.frame_size)), WCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svm.SVMDetector()


# ---- the solver -------------------------------------------------------------------


def test_solver_matches_sklearn_at_a_tight_tolerance():
    x, y, w = problem()
    ref = sklearn_svc(tol=1e-8).fit(x, y, sample_weight=w)
    det = svm.SVMDetector(soft_svm=False, device="cpu", tol=1e-8).fit(x, y, w)
    assert det.gamma == pytest.approx(ref._gamma, rel=1e-15)
    assert set(det.support) == set(ref.support_)
    np.testing.assert_allclose(det.decision_function(x), ref.decision_function(x),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(det.intercept, ref.intercept_[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_default_tolerance_labels_agree_with_sed_tpu(seed):
    x, y, _ = problem(seed=seed)
    ours = svm.SVMDetector(soft_svm=False, device="cpu")
    ours.learn([x[:300]], [y[:300]])
    theirs = jax_svm.SVMDetector(soft_svm=False)
    theirs.learn([x[:300]], [y[:300]])
    assert np.mean(ours.predict(x) == theirs.predict(x)) >= 0.99
    gap = np.abs(ours.decision_function(x) - theirs.svm.decision_function(x)).max()
    assert gap <= DEC_GAP_1E3


def test_carried_arrays_reproduce_sklearn():
    x, y, _ = problem(seed=3)
    theirs = jax_svm.SVMDetector(soft_svm=True)
    theirs.learn([x], [y])
    s = theirs.svm
    ours = svm.SVMDetector.from_sklearn_arrays(s.support_vectors_, s.dual_coef_, s.intercept_,
                                               s._gamma, s._probA, s._probB, s.classes_,
                                               device="cpu")
    np.testing.assert_allclose(ours.decision_function(x), s.decision_function(x),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(ours.predict(x), theirs.predict(x), rtol=0, atol=1e-8)
    hard = svm.SVMDetector.from_sklearn_arrays(s.support_vectors_, s.dual_coef_,
                                               s.intercept_, s._gamma, None, None,
                                               s.classes_, device="cpu")
    np.testing.assert_array_equal(hard.predict(x), s.predict(x))


def test_sigmoid_train_matches_sklearn_calibration():
    from sklearn.calibration import _sigmoid_calibration

    x, y, w = problem(seed=4)
    dec = -sklearn_svc().fit(x, y, sample_weight=w).decision_function(x)  # libsvm's sign
    a, b = svc.sigmoid_train(dec, np.where(y == 0, 1.0, -1.0))
    want_a, want_b = _sigmoid_calibration(dec, (y == 0).astype(int))
    assert abs(a - want_a) <= 1e-4 and abs(b - want_b) <= 1e-4


def test_coupling_matches_predict_proba():
    """libsvm's clipped sigmoid then its two-class coupling reproduce
    ``predict_proba`` from the decision values and A, B."""
    x, y, w = problem(seed=5)
    ref = sklearn_svc(probability=True, random_state=0).fit(x, y, sample_weight=w)
    a, b = float(ref._probA[0]), float(ref._probB[0])
    got = svc.probability(torch.as_tensor(-ref.decision_function(x)), a, b).numpy()
    np.testing.assert_allclose(got, ref.predict_proba(x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=0, atol=1e-12)


def test_soft_scores_ap_within_budget_of_sed_tpu():
    x, y, _ = problem(n=600, seed=6)
    tx, ty, vx, vy = x[:450], y[:450], x[450:], y[450:]
    ours = svm.SVMDetector(soft_svm=True, device="cpu", seed=0)
    ours.learn([tx], [ty])
    theirs = jax_svm.SVMDetector(soft_svm=True)
    np.random.seed(0)   # sed_tpu's SVC draws its folds from numpy's global generator
    theirs.learn([tx], [ty])
    ap_ours = calculate_metrics(ours.predict(vx).reshape(-1, 1), vy.reshape(-1, 1))[2]
    ap_theirs = calculate_metrics(theirs.predict(vx).reshape(-1, 1), vy.reshape(-1, 1))[2]
    assert abs(ap_ours - ap_theirs) <= AP_BUDGET
    assert ours.prob_a < 0


def test_probability_fit_is_seeded():
    x, y, w = problem(n=200, seed=7)
    a = svm.SVMDetector(device="cpu", seed=1).fit(x, y, w)
    b = svm.SVMDetector(device="cpu", seed=1).fit(x, y, w)
    c = svm.SVMDetector(device="cpu", seed=2).fit(x, y, w)
    assert (a.prob_a, a.prob_b) == (b.prob_a, b.prob_b) != (c.prob_a, c.prob_b)


def test_one_class_folds_take_libsvm_constants(monkeypatch):
    """The fold that holds the one row of the second class out trains on
    the first class alone: its held-out rows get +1, without a fit
    (svm_binary_svc_probability)."""
    x = torch.arange(10, dtype=torch.float64)[:, None]
    y = torch.tensor([1.0] * 9 + [-1.0], dtype=torch.float64)
    seen = []

    def capture(dec, labels):
        seen.append(dec)
        return 0.0, 0.0

    monkeypatch.setattr(svc, "sigmoid_train", capture)
    svc.binary_probability(x, y, torch.ones(10, dtype=torch.float64), 1.0,
                           torch.Generator().manual_seed(0))
    perm = torch.randperm(10, generator=torch.Generator().manual_seed(0)).numpy()
    k = int(np.nonzero(perm == 9)[0][0]) // 2
    held = perm[2 * k:2 * k + 2]
    np.testing.assert_array_equal(seen[0][held], 1.0)
    assert np.abs(np.delete(seen[0], held)).max() not in (0.0, 1.0)


def test_one_class_is_refused_as_sklearn_refuses_it():
    x, _, _ = problem(n=20)
    with pytest.raises(ValueError, match="greater than one"):
        svm.SVMDetector(device="cpu").learn([x], [np.zeros(20)])


def test_save_load_round_trip_and_sed_tpus_pickle_refused(tmp_path):
    x, y, w = problem(n=120, seed=8)
    det = svm.SVMDetector(soft_svm=True, device="cpu").fit(x, y, w)
    path = str(tmp_path / "svm.pt")
    det.save(path)
    assert torch.load(path, weights_only=True)["format"] == "sed_tpu_torch.SVMDetector"
    back = svm.SVMDetector(soft_svm=False, device="cpu")
    back.load(path)
    assert back.soft_svm
    np.testing.assert_array_equal(back.predict(x), det.predict(x))
    back.load(str(tmp_path / "absent.pt"))           # sed_tpu's load: a no-op
    theirs = jax_svm.SVMDetector(soft_svm=False)
    theirs.learn([x], [y])
    pkl = str(tmp_path / "last_pickled_model.pkl")
    theirs.save(pkl)
    with open(pkl, "rb") as f:
        assert type(pickle.load(f)).__name__ == "SVC"
    with pytest.raises(ValueError, match="from_sklearn_arrays"):
        back.load(pkl)


def test_split_train_val_matches_sed_tpu():
    data = [(np.full((2, 3), i), np.zeros(2), f"n{i}") for i in range(13)]
    for seed in (0, 5):
        ours = svm.split_train_val(data, seed=seed)
        theirs = jax_svm.split_train_val(data, seed=seed)
        assert ours[4] == theirs[4]
        for a, b in zip(ours[0] + ours[2], theirs[0] + theirs[2]):
            np.testing.assert_array_equal(a, b)


# ---- the CLI ------------------------------------------------------------------------


def film_clap(root, files=5, seconds=6.0, sr=48000, seed=0):
    """A FilmClap-layout corpus: mono WAVs of noise with two clap-like
    bursts each, and the label file of their centres."""
    import json

    rng = np.random.default_rng(seed)
    film = root / "FilmClap" / "film"
    film.mkdir(parents=True)
    labels = {}
    n = int(seconds * sr)
    for i in range(files):
        x = 0.05 * rng.standard_normal(n)
        centers = []
        for start in (0.2 * seconds, 0.6 * seconds):
            a = int(start * sr)
            t = np.arange(int(0.8 * sr)) / sr
            x[a:a + len(t)] += 0.4 * np.sin(2 * np.pi * 2000 * t) * np.exp(-3 * t)
            centers += [start + 0.2, start + 0.5]
        path = str(film / f"clip_{i}.wav")
        wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))
        labels[path] = centers
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        json.dump(labels, f)
    return root


def test_get_raw_data_matches_sed_tpu(tmp_path):
    root = film_clap(tmp_path, files=2, seconds=4.0)
    items = get_film_clap_paths_and_labels(str(root / "FilmClap"), DEFAULT_WAVEFORM.time_margin)
    ours = svm.get_raw_data(items, device="cpu")
    theirs = jax_svm.get_raw_data(jax_film_clap(str(root / "FilmClap"), 0.33))
    assert len(ours) == len(theirs) == 2
    for (f, l, n), (g, m, o) in zip(ours, theirs):
        assert n == o
        np.testing.assert_array_equal(l, m)
        np.testing.assert_allclose(f, np.asarray(g), rtol=0, atol=DB_TOL)


def test_main_end_to_end(tmp_path, capsys):
    root = film_clap(tmp_path)
    out = tmp_path / "model.pt"
    recalls, precisions, aps, accs = svm.main([
        "--dataset_dir", str(root), "--model_out", str(out), "--device", "cpu", "--no_plot",
        "--plots_dir", str(tmp_path / "plots")])
    said = capsys.readouterr().out
    assert "Svm training on" in said and "max f1 score" in said
    assert len(aps) == 1 and np.isfinite(aps).all() and not (tmp_path / "plots").exists()
    det = svm.SVMDetector(device="cpu")
    det.load(str(out))
    assert det.soft_svm and det.support_vectors.shape[1] == 64


def test_main_refuses_plots_without_matplotlib(monkeypatch, tmp_path):
    from sed_tpu_torch.utils import plotting

    def missing():
        raise RuntimeError("the plot needs matplotlib, which is not installed; pass --no_plot")

    monkeypatch.setattr(plotting, "require_matplotlib", missing)
    with pytest.raises(SystemExit):
        svm.main(["--dataset_dir", str(tmp_path / "absent"), "--device", "cpu"])
