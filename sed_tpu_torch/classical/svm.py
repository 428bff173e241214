"""Classical SVM detector over log-mel spectrogram columns (counterpart of
``sed_tpu.classical.svm``).

Reference: Classical_methods/train_svm_detector.py.  The featurizer (frame
split -> Hann -> rFFT -> log-mel) and the SVM both run on the device:
:class:`SVMDetector` computes what ``sklearn.svm.SVC(C=1, kernel="rbf",
gamma="scale", probability=soft_svm)`` computes with the recall-priority
sample weights, through :mod:`sed_tpu_torch.classical.svc` (libsvm's C-SVC
dual by SMO in float64, kernel columns computed on the fly; Platt's A and B
on 5-fold cross-validated decision values; libsvm's clipped sigmoid and
two-class coupling at prediction).  Prediction is vectorized over frames.

Differences from ``sed_tpu`` (scikit-learn):

  * the cross-validation folds of the probability fit are a permutation
    drawn from ``torch.Generator().manual_seed(seed)``; libsvm's draw cannot
    be reproduced, and ``sed_tpu``'s own SVC leaves ``random_state`` unset,
    so its probabilities differ between two fits of the same data;
  * the port's model file is its own ``torch.save`` dict (loadable with
    ``weights_only=True``).  ``sed_tpu``'s pickle of an ``SVC`` needs
    scikit-learn to unpickle and is refused by name;
    :meth:`SVMDetector.from_sklearn_arrays` carries a fitted SVC's arrays.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from sed_tpu_torch.classical import svc
from sed_tpu_torch.configs import DEFAULT_WAVEFORM, SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data.events import frame_coverage_labels
from sed_tpu_torch.io.audio import read_multichannel_audio
from sed_tpu_torch.ops.featurizer import multichannel_complex_to_log_mel
from sed_tpu_torch.utils.plotting import refuse_plot_without_matplotlib

FEATURIZE_ROWS = 512   # frames transformed at once (a 32768-point float64 rFFT each)


def _device(device):
    from sed_tpu_torch.inference import resolve_device

    return resolve_device("cuda" if device is None else device)


class SVMDetector:
    """RBF SVC with recall-priority sample weights (train_svm_detector.py:19-49).

    ``device``: where the solver and the predictions run (default 'cuda';
    pass 'cpu' to run on the CPU).  ``tol``: the solver's stopping
    tolerance (scikit-learn's default 1e-3).  ``seed``: the probability
    fit's fold permutation.  After :meth:`learn`: ``n_iter`` (the final
    fit's SMO iterations) and ``fit_seconds``.
    """

    def __init__(self, soft_svm: bool = True, recall_priority: float = 10.0, seed: int = 0,
                 device=None, tol: float = 1e-3):
        self.soft_svm = soft_svm
        self.recall_priority = recall_priority
        self.seed = seed
        self.tol = tol
        self.device = _device(device)
        self.support_vectors = None   # (n_sv, d) float64 on the device
        self.dual_coef = None         # (n_sv,) scikit-learn's dual_coef_[0]
        self.intercept = None         # scikit-learn's intercept_[0]
        self.gamma = None
        self.prob_a = self.prob_b = None
        self.classes = None
        self.support = None
        self.n_iter = 0
        self.fit_seconds = 0.0

    def learn(self, spectrograms, event_matrices):
        data = np.concatenate(spectrograms, axis=0)
        labels = np.concatenate(event_matrices, axis=0)
        sample_weights = labels * self.recall_priority + (1 - labels)
        print(f"Svm training on {len(data)} samples... ", end="")
        self.fit(data, labels, sample_weights)
        print("Done")

    def fit(self, x, labels, sample_weight=None):
        """Fit on ``x`` (n, d) with ``labels`` of two classes and per-row
        weights (default 1): C w_i bounds each dual variable."""
        t0 = time.perf_counter()
        x = np.asarray(x, dtype=np.float64)
        labels = np.asarray(labels).ravel()
        classes = np.unique(labels)
        if len(classes) < 2:
            raise ValueError(f"The number of classes has to be greater than one; got "
                             f"{len(classes)} class")
        if len(classes) > 2:
            raise ValueError(f"SVMDetector is a two-class detector; got {len(classes)} classes")
        w = (np.ones(len(x)) if sample_weight is None
             else np.asarray(sample_weight, dtype=np.float64).ravel())
        self.gamma = svc.gamma_scale(x)
        xd = torch.as_tensor(x, device=self.device)
        # libsvm's +1 is the first class in sorted order.
        y = torch.as_tensor(np.where(labels == classes[0], 1.0, -1.0), device=self.device)
        c = torch.as_tensor(w, device=self.device)
        if self.soft_svm:
            gen = torch.Generator().manual_seed(self.seed)
            self.prob_a, self.prob_b = svc.binary_probability(xd, y, c, self.gamma, gen,
                                                              self.tol)
        else:
            self.prob_a = self.prob_b = None
        model = svc.train(xd, y, c, self.gamma, self.tol)
        self.support = model.support.cpu().numpy()
        self.support_vectors = model.support_vectors
        self.dual_coef = -model.sv_coef
        self.intercept = model.rho
        self.classes = classes
        self.n_iter = model.n_iter
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fit_seconds = time.perf_counter() - t0
        return self

    @classmethod
    def from_sklearn_arrays(cls, support_vectors, dual_coef, intercept, gamma, prob_a, prob_b,
                            classes, recall_priority: float = 10.0, device=None):
        """A detector with a fitted ``sklearn.svm.SVC``'s arrays, numpy
        only: ``support_vectors_``, ``dual_coef_``, ``intercept_``,
        ``_gamma``, ``_probA`` and ``_probB`` (empty or None without
        probabilities; then ``predict`` gives hard labels) and
        ``classes_``."""
        prob_a = None if prob_a is None else np.asarray(prob_a, dtype=np.float64).ravel()
        prob_b = None if prob_b is None else np.asarray(prob_b, dtype=np.float64).ravel()
        soft = prob_a is not None and prob_a.size > 0
        det = cls(soft_svm=soft, recall_priority=recall_priority, device=device)
        det._set(np.asarray(support_vectors, dtype=np.float64),
                 np.asarray(dual_coef, dtype=np.float64).ravel(),
                 float(np.asarray(intercept, dtype=np.float64).ravel()[0]), float(gamma),
                 float(prob_a[0]) if soft else None, float(prob_b[0]) if soft else None,
                 np.asarray(classes))
        return det

    def _set(self, support_vectors, dual_coef, intercept, gamma, prob_a, prob_b, classes):
        if len(classes) != 2:
            raise ValueError(f"SVMDetector is a two-class detector; got {len(classes)} classes")
        self.support_vectors = torch.as_tensor(support_vectors, device=self.device)
        self.dual_coef = torch.as_tensor(dual_coef, device=self.device)
        self.intercept, self.gamma = intercept, gamma
        self.prob_a, self.prob_b = prob_a, prob_b
        self.classes = classes

    def _libsvm_decision(self, x) -> torch.Tensor:
        """libsvm's decision value (positive for the first class)."""
        if self.support_vectors is None:
            raise RuntimeError("the SVMDetector is not fitted")
        xd = torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)
        return svc.decision_values(xd, self.support_vectors, -self.dual_coef,
                                   self.intercept, self.gamma)

    def decision_function(self, x) -> np.ndarray:
        """scikit-learn's ``decision_function``: positive for the second
        class."""
        return (-self._libsvm_decision(x)).cpu().numpy()

    def predict(self, spectrogram) -> np.ndarray:
        dec = self._libsvm_decision(spectrogram)
        if self.soft_svm:
            return svc.probability(dec, self.prob_a, self.prob_b)[:, 1].cpu().numpy()
        return np.where((dec > 0).cpu().numpy(), self.classes[0], self.classes[1])

    def save(self, path: str) -> None:
        torch.save({"format": "sed_tpu_torch.SVMDetector", "soft_svm": self.soft_svm,
                    "recall_priority": self.recall_priority,
                    "support_vectors": self.support_vectors.cpu(),
                    "dual_coef": self.dual_coef.cpu(), "intercept": float(self.intercept),
                    "gamma": float(self.gamma),
                    "prob_a": None if self.prob_a is None else float(self.prob_a),
                    "prob_b": None if self.prob_b is None else float(self.prob_b),
                    "classes": torch.as_tensor(self.classes)}, path)

    def load(self, path: str) -> None:
        """Load a file :meth:`save` wrote; a missing path leaves the
        detector as it is, as ``sed_tpu``'s ``load`` does."""
        if not os.path.exists(path):
            return
        try:
            d = torch.load(path, map_location="cpu", weights_only=True)
        except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
            raise ValueError(
                f"{path} is not the port's SVM file: sed_tpu's pickled sklearn SVC needs "
                f"scikit-learn to unpickle; carry its arrays with "
                f"SVMDetector.from_sklearn_arrays(svm.support_vectors_, svm.dual_coef_, "
                f"svm.intercept_, svm._gamma, svm._probA, svm._probB, svm.classes_)"
            ) from e
        if not isinstance(d, dict) or d.get("format") != "sed_tpu_torch.SVMDetector":
            raise ValueError(f"{path} is not the port's SVM file")
        self.soft_svm = d["soft_svm"]
        self.recall_priority = d["recall_priority"]
        self._set(d["support_vectors"].numpy(), d["dual_coef"].numpy(), d["intercept"],
                  d["gamma"], d["prob_a"], d["prob_b"], d["classes"].numpy())


def featurize_frames(frames: np.ndarray, cfg: WaveformConfig = DEFAULT_WAVEFORM,
                     device=None) -> np.ndarray:
    """(n_frames, frame_size) waveform frames -> (n_frames, mel) log-mel rows.

    Reference: train_svm_detector.py:62-68, as ``sed_tpu`` computes it:
    ``frames * np.hanning(frame_size)`` (the symmetric Hann, at the start of
    the row) and ``rfft`` with ``n=nfft`` (zero padding at the end) in
    float64 on ``device``, a complex64 cast, then
    ``multichannel_complex_to_log_mel`` (PyTorch ops, ``use_pallas=False``).
    Not K3: K3's window is centred.
    """
    device = _device(device)
    scfg = SpectrogramConfig(
        working_sample_rate=cfg.working_sample_rate,
        time_margin=cfg.time_margin,
        audio_channels=cfg.audio_channels,
        tau_sed_labels=cfg.tau_sed_labels,
    )
    frames = np.asarray(frames)
    hann = torch.as_tensor(np.hanning(cfg.frame_size), device=device)
    out = []
    for s in range(0, len(frames), FEATURIZE_ROWS):
        rows = torch.as_tensor(frames[s:s + FEATURIZE_ROWS], dtype=torch.float64,
                               device=device)
        spec = torch.fft.rfft(rows * hann, n=scfg.nfft).to(torch.complex64)
        out.append(multichannel_complex_to_log_mel(spec, scfg).cpu().numpy())
    if not out:
        return np.zeros((0, scfg.mel_bins), np.float32)
    return np.concatenate(out)


def get_raw_data(audio_paths_labels_and_names, cfg: WaveformConfig = DEFAULT_WAVEFORM,
                 device=None):
    """Per file: read audio -> hop-strided frames + coverage labels -> log-mel rows.

    Reference: train_svm_detector.py:51-75.
    """
    data = []
    for audio_path, start_times, end_times, audio_name in audio_paths_labels_and_names:
        waveform = read_multichannel_audio(audio_path, target_fs=cfg.working_sample_rate, cfg=cfg)
        waveform = waveform.T  # (channels, samples)
        frames, labels = frame_coverage_labels(waveform, start_times, end_times, cfg)
        flat = frames.reshape(frames.shape[0] * frames.shape[1], -1)  # concat channels
        mel = featurize_frames(flat, cfg, device)
        data.append((mel, np.asarray(labels, dtype=np.float64), audio_name))
    return data


def split_train_val(all_data, seed=None):
    """80/20 shuffle split (reference: train_svm_detector.py:77-92), the
    permutation ``sed_tpu`` draws from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    all_data = list(all_data)
    order = rng.permutation(len(all_data))
    all_data = [all_data[i] for i in order]
    features, events, names = zip(*all_data)
    val_amount = len(features) // 5
    return (
        list(features[val_amount:]), list(events[val_amount:]),
        list(features[:val_amount]), list(events[:val_amount]), list(names[:val_amount]),
    )


def evaluate_model(model: SVMDetector, eval_data, plots_dir: str = "plots",
                   plot: bool = True):
    """Per-recording metrics, and plots unless ``plot`` is False
    (reference: train_svm_detector.py:94-128)."""
    from sed_tpu_torch.utils.metrics import calculate_metrics, f_score

    recal_sets, precision_sets, aps, accs = [], [], [], []
    for feature, event_mat, name in eval_data:
        pred = model.predict(feature)
        acc = float(np.mean((pred > 0.5) == event_mat)) if model.soft_svm else float(
            np.mean(pred == event_mat)
        )
        recals, precisions, ap = calculate_metrics(pred.reshape(-1, 1), event_mat.reshape(-1, 1))
        f1s = [f_score(r, p, 1) for r, p in zip(recals, precisions)]
        print(f"{name} max f1 score: {np.max(f1s)}")
        recal_sets.append(recals)
        precision_sets.append(precisions)
        aps.append(ap)
        accs.append(acc)
        if plot:
            from sed_tpu_torch.utils.plotting import plot_sample_features

            os.makedirs(plots_dir, exist_ok=True)
            plot_sample_features(
                np.array([feature]), mode="spectogram",
                output=pred.reshape(-1, 1), target=event_mat.reshape(-1, 1),
                file_name=f"Acc:{acc:.2f}, AP: {ap:.2f}, f1: {np.max(f1s):.2f}",
                plot_path=os.path.join(plots_dir, f"{name}-f1-{np.max(f1s):.2f}.png"),
            )
    return recal_sets, precision_sets, aps, accs


def build_arg_parser():
    import argparse

    parser = argparse.ArgumentParser(
        description="SVM sound-event detector (classical baseline, PyTorch/CUDA port)")
    parser.add_argument("--dataset_dir", type=str, default="../data")
    parser.add_argument("--recall_priority", type=float, default=10.0)
    parser.add_argument("--model_out", type=str, default="last_pickled_model.pkl",
                        help="the port's SVM file (torch.save of a dict)")
    parser.add_argument("--plots_dir", type=str, default="plots")
    parser.add_argument("--seed", type=int, default=0,
                        help="the train/validation split and the probability fit's folds")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the featurizer and the SVM: cuda (default) or cpu")
    parser.add_argument("--no_plot", action="store_true", default=False,
                        help="write no PNGs (they need matplotlib)")
    return parser


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_plot_without_matplotlib(parser, args.no_plot)

    from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels

    cfg = DEFAULT_WAVEFORM
    device = _device(args.device)
    items = get_film_clap_paths_and_labels(
        os.path.join(args.dataset_dir, "FilmClap"), time_margin=cfg.time_margin
    )
    all_data = get_raw_data(items, cfg, device)
    train_x, train_y, val_x, val_y, val_names = split_train_val(all_data, seed=args.seed)

    model = SVMDetector(soft_svm=True, recall_priority=args.recall_priority, seed=args.seed,
                        device=device)
    model.learn(train_x, train_y)
    model.save(args.model_out)
    return evaluate_model(model, zip(val_x, val_y, val_names), plots_dir=args.plots_dir,
                          plot=not args.no_plot)


if __name__ == "__main__":
    main()
