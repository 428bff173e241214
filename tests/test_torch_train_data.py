"""The port's training data path against sed_tpu's, on the CPU.

Labels, event rasterization, train/validation splits, the FilmClap and TAU
parsers, preprocess_data's pickles and SpectrogramDataset: the same inputs
through both packages.  Tolerances: preprocess features within 1e-4 dB
(logMel; the port's plain K1 + K2 against sed_tpu's XLA featurizer) and the
mean/std within 1e-4; complex spectra within 1e-5 of each frame's peak
magnitude; everything else (event matrices, splits, start indices, epoch
batches, labels) identical.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.data import events as jax_events
from sed_tpu.data import split as jax_split
from sed_tpu.data import spectrogram_dataset as jax_ds
from sed_tpu.data.preprocess import preprocess_data as jax_preprocess_data
from sed_tpu.io import film_clap as jax_film_clap
from sed_tpu.io import labels as jax_labels
from sed_tpu.io import tau as jax_tau
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.data import events, split
from sed_tpu_torch.data import spectrogram_dataset as ds
from sed_tpu_torch.data.preprocess import calculate_scalar_of_tensor, preprocess_data
from sed_tpu_torch.io import film_clap, labels, tau

# Small config: 8 kHz, frame 5280, hop 2640, fps 3, NFFT 8192.
CFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
JCFG = JaxSpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
DB_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synthetic_corpus(tmp_path_factory):
    """Six 15 s synthetic wavs with one event each + label tuples (the
    corpus of tests/test_data.py)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    items = []
    for i in range(6):
        dur, sr = 15.0, CFG.working_sample_rate
        n = int(dur * sr)
        sig = 0.01 * rng.standard_normal(n)
        start = 4.0 + i * 0.5
        end = start + 1.0
        t = np.arange(int(sr * (end - start))) / sr
        sig[int(start * sr):int(start * sr) + len(t)] += 0.5 * np.sin(2 * np.pi * 800 * t)
        path = str(root / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        items.append((path, np.array([start]), np.array([end]), f"clip_{i}"))
    return items


def _preprocess_both(items, mode, out):
    """(port features_dir, port mean_std, sed_tpu features_dir, sed_tpu mean_std)."""
    paths = []
    for tag, fn, cfg, kw in (("torch", preprocess_data, CFG, {"device": "cpu"}),
                             ("jax", jax_preprocess_data, JCFG, {})):
        features_dir = str(out / f"{tag}-{mode}-features")
        mean_std = str(out / f"{tag}-{mode}-mean_std.pkl")
        fn(items, features_dir, mean_std, preprocess_mode=mode, cfg=cfg,
           plot_sample=False, **kw)
        paths += [features_dir, mean_std]
    return tuple(paths)


@pytest.fixture(scope="module")
def preprocessed(synthetic_corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("features")
    return {mode: _preprocess_both(synthetic_corpus, mode, out)
            for mode in ("logMel", "Complex")}


# ---------------------------------------------------------------------------
# Labels, events, split
# ---------------------------------------------------------------------------

def test_labeled_audio_is_the_reference_tuple():
    a = labels.LabeledAudio("a.wav", [1.0, 2.0], [1.5, 2.5], "a", [0, 1])
    b = jax_labels.LabeledAudio("a.wav", [1.0, 2.0], [1.5, 2.5], "a", [0, 1])
    assert tuple(a) == tuple(b)
    assert (a.audio_path, a.name) == ("a.wav", "a")
    np.testing.assert_array_equal(labels.event_class_indices(a),
                                  jax_labels.event_class_indices(b))
    assert labels.event_class_indices(("a.wav", [], [], "a")) is None
    with pytest.raises(ValueError):
        labels.LabeledAudio("a.wav", [1.0], [2.0], "a", [0, 1])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("multiclass", [False, True], ids=["blind", "multiclass"])
def test_event_rasterizers_match_sed_tpu(seed, multiclass):
    rng = np.random.default_rng(seed)
    acfg = SpectrogramConfig(working_sample_rate=8000,
                             tau_sed_labels=("a", "b", "c"))
    jcfg = JaxSpectrogramConfig(working_sample_rate=8000,
                                tau_sed_labels=("a", "b", "c"))
    n_ev = int(rng.integers(0, 6))
    starts = np.sort(rng.uniform(-0.5, 14.0, n_ev))
    ends = starts + rng.uniform(0.05, 3.0, n_ev)
    cls = rng.integers(0, 3, n_ev) if multiclass else None
    frames = int(rng.integers(10, 60))
    np.testing.assert_array_equal(
        events.create_event_matrix(frames, starts, ends, acfg, cls),
        jax_events.create_event_matrix(frames, starts, ends, jcfg, cls))
    length = 15 * 8000
    np.testing.assert_array_equal(
        events.start_index_labels(length, starts, ends, acfg, cls),
        jax_events.start_index_labels(length, starts, ends, jcfg, cls))
    wave = rng.standard_normal((1, length)).astype(np.float32)
    f1, l1 = events.frame_coverage_labels(wave, starts, ends, acfg, cls)
    f2, l2 = jax_events.frame_coverage_labels(wave, starts, ends, jcfg, cls)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("descriptor", [0.2, 0.5, 0.34, "clip_3", "_1"])
@pytest.mark.parametrize("seed", [None, 0, 7])
def test_split_train_val_matches_sed_tpu(descriptor, seed):
    items = [f"/data/features/clip_{i}_logMel.pkl" for i in range(11)]
    key = os.path.basename
    if seed is None and isinstance(descriptor, float):
        # Unseeded float splits draw fresh entropy: compare the partition only.
        train, val = split.split_train_val(items, descriptor, key=key, seed=seed)
        assert sorted(train + val) == sorted(items)
        assert len(val) == int(len(items) * descriptor)
        return
    assert split.split_train_val(items, descriptor, key=key, seed=seed) == \
        jax_split.split_train_val(items, descriptor, key=key, seed=seed)


@pytest.mark.parametrize("seed", range(3))
def test_classify_start_indices_matches_sed_tpu(seed):
    rng = np.random.default_rng(seed)
    frames = int(rng.integers(20, 120))
    em = (rng.random((frames, 2)) > 0.85).astype(np.float32)
    for crop in (5, 30):
        num_starts = frames - crop
        np.testing.assert_array_equal(
            ds.classify_start_indices(em, num_starts, crop),
            jax_ds.classify_start_indices(em, num_starts, crop))


# ---------------------------------------------------------------------------
# Dataset parsers
# ---------------------------------------------------------------------------

def _items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x[0], x[3]) == (y[0], y[3])
        np.testing.assert_array_equal(np.asarray(x[1], np.float64), np.asarray(y[1], np.float64))
        np.testing.assert_array_equal(np.asarray(x[2], np.float64), np.asarray(y[2], np.float64))
        np.testing.assert_array_equal(labels.event_class_indices(x),
                                      jax_labels.event_class_indices(y))


def test_film_clap_paths_and_labels_match_sed_tpu(tmp_path):
    film_dir = tmp_path / "FilmClap" / "filmA"
    film_dir.mkdir(parents=True)
    table = {}
    for i in range(3):
        path = str(film_dir / f"clip_{i}.wav")
        wavfile.write(path, 8000, np.zeros(800, np.int16))
        table[path] = [1.0 + i, 4.5]
    with open(tmp_path / "FilmClap" / film_clap.LABEL_FILE, "w") as f:
        json.dump(table, f)
    root = str(tmp_path / "FilmClap")
    for margin in (0.1, 0.33):
        _items_equal(film_clap.get_film_clap_paths_and_labels(root, margin),
                     jax_film_clap.get_film_clap_paths_and_labels(root, margin))


@pytest.mark.parametrize("tau_labels", [("doorslam",), ("doorslam", "speech")])
def test_tau_paths_and_labels_match_sed_tpu(tmp_path, tau_labels):
    """A synthetic metadata folder in tests/test_tau.py's layout."""
    audio_dir = tmp_path / "foa_eval"
    meta_dir = tmp_path / "metadata_eval"
    audio_dir.mkdir()
    meta_dir.mkdir()
    rows = {
        "split0_1": [("doorslam", 1.0, 1.5), ("speech", 2.0, 3.0), ("doorslam", 5.0, 5.5)],
        "split0_2": [("speech", 0.25, 1.75)],
        "split1_1": [("doorslam", 4.0, 5.0), ("speech", 8.0, 9.0), ("cough", 2.0, 2.5)],
    }
    for name, evs in rows.items():
        wavfile.write(str(audio_dir / f"{name}.wav"), 48000, np.zeros(1000, np.int16))
        with open(meta_dir / f"{name}.csv", "w") as f:
            f.write("sound_event_recording,start_time,end_time,ele,azi,dist\n")
            for label, s, e in evs:
                f.write(f"{label},{s},{e},0,10,2\n")
    acfg = SpectrogramConfig(tau_sed_labels=tau_labels)
    jcfg = JaxSpectrogramConfig(tau_sed_labels=tau_labels)
    _items_equal(tau.get_tau_sed_paths_and_labels(str(audio_dir), str(meta_dir), acfg),
                 jax_tau.get_tau_sed_paths_and_labels(str(audio_dir), str(meta_dir), jcfg))


def test_tau_existing_raw_data_is_used(tmp_path):
    raw = tmp_path / "raw"
    (raw / "foa_eval").mkdir(parents=True)
    (raw / "metadata_eval").mkdir()
    assert tau.ensure_tau_data(str(tmp_path)) == jax_tau.ensure_tau_data(str(tmp_path))
    assert tau.FOA_ARTIFACTS == jax_tau.FOA_ARTIFACTS


# ---------------------------------------------------------------------------
# preprocess_data
# ---------------------------------------------------------------------------

def test_calculate_scalar_of_tensor():
    x = np.random.default_rng(0).standard_normal((2, 40, 8))
    m, s = calculate_scalar_of_tensor(x)
    np.testing.assert_array_equal(m, x.mean(axis=(0, 1)))
    np.testing.assert_array_equal(s, x.std(axis=(0, 1)))
    m2, _ = calculate_scalar_of_tensor(x[0])
    np.testing.assert_array_equal(m2, x[0].mean(axis=0))
    with pytest.raises(ValueError):
        calculate_scalar_of_tensor(x[None])


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
def test_preprocess_pickles_match_sed_tpu(preprocessed, mode):
    t_dir, t_ms, j_dir, j_ms = preprocessed[mode]
    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir)) and len(names) == 6
    for name in names:
        with open(os.path.join(t_dir, name), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(j_dir, name), "rb") as f:
            b = pickle.load(f)
        assert set(a) == set(b) == {"features", "start_times", "end_times", "class_indices"}
        assert a["features"].shape == b["features"].shape
        assert a["features"].dtype == b["features"].dtype
        if mode == "logMel":
            assert np.abs(a["features"] - b["features"]).max() <= DB_TOL
        else:
            peak = np.abs(b["features"]).max(axis=-1, keepdims=True)
            assert (np.abs(a["features"] - b["features"]) / peak).max() <= 1e-5
        np.testing.assert_array_equal(a["start_times"], b["start_times"])
        np.testing.assert_array_equal(a["end_times"], b["end_times"])
        assert a["class_indices"] is None and b["class_indices"] is None
    with open(t_ms, "rb") as f:
        a = pickle.load(f)
    with open(j_ms, "rb") as f:
        b = pickle.load(f)
    tol = DB_TOL if mode == "logMel" else 1e-5 * np.abs(b["mean"]).max()
    assert np.abs(a["mean"] - b["mean"]).max() <= tol
    assert np.abs(a["std"] - b["std"]).max() <= (DB_TOL if mode == "logMel"
                                                 else 1e-5 * np.abs(b["std"]).max())


def test_preprocess_refuses_workers(synthetic_corpus, tmp_path):
    """``workers > 0``, once refused, reads ahead on the native reader's
    threads: at the working rate every pickle and the mean/std equal
    ``workers=0``'s."""
    for w in (0, 2):
        preprocess_data(synthetic_corpus, str(tmp_path / f"f{w}"), str(tmp_path / f"m{w}.pkl"),
                        cfg=CFG, workers=w, device="cpu", plot_sample=False)
    names = sorted(os.listdir(tmp_path / "f0"))
    assert names == sorted(os.listdir(tmp_path / "f2")) and len(names) == len(synthetic_corpus)
    for name in [*names, None]:
        a, b = ((tmp_path / f"f{w}" / name) if name else tmp_path / f"m{w}.pkl" for w in (0, 2))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            da, db = pickle.load(fa), pickle.load(fb)
        assert da.keys() == db.keys()
        for key in da:
            np.testing.assert_array_equal(da[key], db[key])


# ---------------------------------------------------------------------------
# SpectrogramDataset
# ---------------------------------------------------------------------------

def _datasets(preprocessed, mode, **kw):
    """Both packages' datasets over the same (sed_tpu's) pickles."""
    _, _, j_dir, j_ms = preprocessed[mode]
    a = ds.SpectrogramDataset(j_dir, j_ms, preprocessed_mode=mode, cfg=CFG, **kw)
    b = jax_ds.SpectrogramDataset(j_dir, j_ms, preprocessed_mode=mode, cfg=JCFG, **kw)
    return a, b


@pytest.mark.parametrize("balance", [False, True], ids=["all", "balanced"])
@pytest.mark.parametrize("val", [0.34, "clip_5"])
def test_dataset_order_and_batches_match_sed_tpu(preprocessed, balance, val):
    a, b = _datasets(preprocessed, "logMel", val_descriptor=val, balance_classes=balance,
                     seed=3)
    assert a.val_feature_paths == b.val_feature_paths
    np.testing.assert_array_equal(a.train_start_indices, b.train_start_indices)
    assert a.train_start_indices.dtype == np.int32
    np.testing.assert_array_equal(a.train_features, b.train_features)
    np.testing.assert_array_equal(a.train_event_matrix, b.train_event_matrix)
    assert len(a) == len(b)
    for x, y in zip(a.epoch_start_indices(4), b.epoch_start_indices(4)):
        np.testing.assert_array_equal(x, y)
    assert len(list(a.epoch_start_indices(4, drop_last=False))) == -(-len(a) // 4)
    if balance:  # this corpus's events lie before the first crop: no start has one
        assert len(a) == 0


def test_balance_classes_matches_sed_tpu(tmp_path):
    """Events late in each recording, so both classes of start exist."""
    rng = np.random.default_rng(5)
    features_dir = tmp_path / "features"
    features_dir.mkdir()
    for i in range(4):
        with open(features_dir / f"rec_{i}_logMel_features_and_labels.pkl", "wb") as f:
            pickle.dump({"features": rng.standard_normal((1, 90, 64)).astype(np.float32),
                         "start_times": np.array([18.0 + i, 25.0]),
                         "end_times": np.array([19.5 + i, 25.5]), "class_indices": None}, f)
    mean_std = str(tmp_path / "mean_std.pkl")
    with open(mean_std, "wb") as f:
        pickle.dump({"mean": np.zeros(64, np.float32), "std": np.ones(64, np.float32)}, f)
    sizes = []
    for balance in (False, True):
        a = ds.SpectrogramDataset(str(features_dir), mean_std, 0.25, balance_classes=balance,
                                  preprocessed_mode="logMel", cfg=CFG, seed=2)
        b = jax_ds.SpectrogramDataset(str(features_dir), mean_std, 0.25,
                                      balance_classes=balance, preprocessed_mode="logMel",
                                      cfg=JCFG, seed=2)
        np.testing.assert_array_equal(a.train_start_indices, b.train_start_indices)
        sizes.append(len(a))
    assert 0 < sizes[1] < sizes[0] and sizes[1] % 2 == 0


@pytest.mark.parametrize("mode", ["logMel", "Complex"])
def test_dataset_items_and_validation_match_sed_tpu(preprocessed, mode):
    a, b = _datasets(preprocessed, mode, val_descriptor=0.34, seed=1)
    tol = 1e-6 if mode == "logMel" else 1e-4   # Complex: dB of the normalized spectrum
    for idx in (0, 5, len(a) - 1):
        xa, ea = a.get_item(idx)
        xb, eb = b.get_item(idx)
        assert xa.shape == xb.shape
        assert np.abs(xa - np.asarray(xb)).max() <= tol
        np.testing.assert_array_equal(ea, eb)
    va = list(a.get_validation_sampler())
    vb = list(b.get_validation_sampler(max_validate_num=None))
    assert [v[2] for v in va] == [v[2] for v in vb] and len(va) == 2
    for (fa, ta, _), (fb, tb, _) in zip(va, vb):
        assert fa.shape == fb.shape and fa.shape[0] == 1
        assert np.abs(fa - np.asarray(fb)).max() <= tol
        np.testing.assert_array_equal(ta, tb)
    assert len(list(a.get_validation_sampler(1))) == 1


def test_dataset_refuses_logmel_augmentation(preprocessed):
    _, _, j_dir, j_ms = preprocessed["logMel"]
    with pytest.raises(AssertionError):
        ds.SpectrogramDataset(j_dir, j_ms, 0.2, augment_data=True,
                              preprocessed_mode="logMel", cfg=CFG)


def test_film_clap_orchestrator_caches(tmp_path):
    """preprocess_film_clap_data builds the cache once, under sed_tpu's
    descriptor-named directory, and reuses it."""
    film_dir = tmp_path / "FilmClap" / "filmA"
    film_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    table = {}
    for i in range(2):
        path = str(film_dir / f"clip_{i}.wav")
        wavfile.write(path, 8000, (0.01 * rng.standard_normal(8000 * 12)).astype(np.float32))
        table[path] = [5.0]
    with open(tmp_path / "FilmClap" / film_clap.LABEL_FILE, "w") as f:
        json.dump(table, f)
    a = ds.preprocess_film_clap_data(str(tmp_path), "logMel", cfg=CFG, device="cpu",
                                     plot_sample=False)
    assert a[0].startswith(str(tmp_path / "FilmClap" / "processed" / CFG.cfg_descriptor))
    assert len(os.listdir(a[0])) == 2 and os.path.exists(a[1])
    mtime = os.path.getmtime(a[1])
    assert ds.preprocess_film_clap_data(str(tmp_path), "logMel", cfg=CFG, device="cpu") == a
    assert os.path.getmtime(a[1]) == mtime
