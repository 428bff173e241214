"""Exploration playground: classify positive against negative spectrogram
frames with a frame-level SVM (counterpart of the root
``play_with_spectograms.py``; reference:
Classical_methods/play_with_spectograms.py).

    python -m sed_tpu_torch.scripts.play_with_spectograms --dataset_dir D
        [--val_descriptor 0.2] [--holdout 100] [--seed 0]
        [--device cuda|cpu] [--no_plot]

Preprocesses the FilmClap set in logMel mode on ``--device`` if needed
(``--no_plot``: without the sample plot), gathers the event and empty frame
columns of the training part, balances them, and fits the port's SVC on
``--device`` (:class:`sed_tpu_torch.classical.svm.SVMDetector` with unit
weights and no probabilities: ``SVC(C=1, kernel="rbf")``); prints the
held-out accuracy.
"""

from __future__ import annotations

import argparse

import numpy as np

from sed_tpu_torch.utils.plotting import refuse_plot_without_matplotlib


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Frame-level SVM on spectrogram columns (PyTorch/CUDA port)")
    parser.add_argument("--dataset_dir", type=str, default="../data")
    parser.add_argument("--val_descriptor", type=float, default=0.2)
    parser.add_argument("--holdout", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the featurizer and the SVM: cuda (default) or cpu")
    parser.add_argument("--no_plot", action="store_true", default=False,
                        help="preprocess without the sample plot (it needs matplotlib)")
    return parser


def balanced_frames(dataset, seed):
    """(data, labels): the training part's event columns and as many
    empty ones drawn with replacement, shuffled (the root script's draws
    from ``np.random.default_rng(seed)``)."""
    pos_frames, neg_frames = [], []
    for idx in dataset.train_start_indices:
        features = dataset.train_features[0, idx]
        label = dataset.train_event_matrix[idx, 0]
        (pos_frames if label else neg_frames).append(features)
    pos_frames = np.array(pos_frames)
    neg_frames = np.array(neg_frames)
    rng = np.random.default_rng(seed)
    neg_frames = neg_frames[rng.integers(len(neg_frames), size=len(pos_frames))]

    labels = np.zeros(len(pos_frames) + len(neg_frames))
    labels[: len(pos_frames)] = 1
    data = np.concatenate((pos_frames, neg_frames), axis=0)
    order = rng.permutation(len(data))
    return data[order], labels[order]


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    refuse_plot_without_matplotlib(parser, args.no_plot)

    from sed_tpu_torch.classical.svm import SVMDetector
    from sed_tpu_torch.data.spectrogram_dataset import (
        SpectrogramDataset,
        preprocess_film_clap_data,
    )
    from sed_tpu_torch.inference import resolve_device

    device = resolve_device(args.device)
    features_dir, mean_std_file = preprocess_film_clap_data(
        args.dataset_dir, preprocessed_mode="logMel", force_preprocess=False,
        device=device, plot_sample=not args.no_plot,
    )
    dataset = SpectrogramDataset(
        features_dir, mean_std_file,
        augment_data=False, balance_classes=False,
        val_descriptor=args.val_descriptor, preprocessed_mode="logMel",
        seed=args.seed,
    )
    data, labels = balanced_frames(dataset, args.seed)

    print("Classifying")
    classifier = SVMDetector(soft_svm=False, device=device)
    n = args.holdout
    classifier.fit(data[:-n], labels[:-n])
    predictions = classifier.predict(data[-n:])
    accuracy = np.mean(predictions == labels[-n:])
    print(f"held-out accuracy: {accuracy}")
    return accuracy


if __name__ == "__main__":
    main()
