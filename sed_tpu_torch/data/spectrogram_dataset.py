"""Spectrogram crop dataset: packed in-memory store + start-index sampling
(counterpart of ``sed_tpu.data.spectrogram_dataset``).

Reference: dataset/spectogram/spectograms_dataset.py:17-202.  The reference
concatenates every file's spectrogram along the time axis into one long array
and trains on random fixed-size crops addressed by a precomputed, shuffled
list of legal start indices.  That design is kept; the per-item work (crop
gather, normalization, augmentation) runs in the device train step
(sed_tpu_torch.data.device_pipeline), so the packed arrays are uploaded once
and the host only sends start indices.  The host draws (split, start-index
order) are ``sed_tpu``'s, from the same seeded numpy generator, so both
packages train on the same batches.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from sed_tpu_torch.configs import DEFAULT_SPECTROGRAM, SpectrogramConfig
from sed_tpu_torch.data.events import create_event_matrix
from sed_tpu_torch.data.split import split_train_val
from sed_tpu_torch.io.film_clap import get_film_clap_paths_and_labels
from sed_tpu_torch.io.tau import ensure_tau_data, get_tau_sed_paths_and_labels


@dataclass
class PackedTrainData:
    """Concatenated features (C, T, bins), events (T, classes), start indices (N,)."""

    features: np.ndarray
    event_matrix: np.ndarray
    start_indices: np.ndarray


def classify_start_indices(event_matrix: np.ndarray, num_starts: int, crop_size: int):
    """Mark each legal start index as event/empty.

    Reference semantics (spectograms_dataset.py:168-172): for every frame i
    with an active event, start indices in [i - crop, i) are "with event".
    The reference's raw slice assignment makes i < crop mark nothing (negative
    python slicing) — reproduced here.
    """
    num_starts = max(num_starts, 0)  # recordings shorter than the crop yield no starts
    flags = np.zeros(num_starts, dtype=bool)
    event_frames = np.where(event_matrix.max(axis=1) > 0)[0]
    event_frames = event_frames[event_frames >= crop_size]
    if event_frames.size:
        starts = event_frames - crop_size
        ends = np.minimum(event_frames, num_starts)
        valid = starts < ends
        diff = np.zeros(num_starts + 1, dtype=np.int64)
        np.add.at(diff, starts[valid], 1)
        np.add.at(diff, ends[valid], -1)
        flags = np.cumsum(diff[:-1]) > 0
    return flags


def read_train_data_to_memory(
    train_feature_paths: List[str],
    crop_size: int,
    balance_classes: bool = False,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    rng: Optional[np.random.Generator] = None,
) -> PackedTrainData:
    """Reference _read_train_data_to_memory (spectograms_dataset.py:138-187)."""
    rng = rng or np.random.default_rng()
    frame_index = 0
    features_list, event_list = [], []
    idx_with_event, idx_empty = [], []

    for feature_path in train_feature_paths:
        with open(feature_path, "rb") as f:
            data = pickle.load(f)
        feature = data["features"]
        event_matrix = create_event_matrix(
            feature.shape[1], data["start_times"], data["end_times"], cfg,
            class_indices=data.get("class_indices"),
        )
        frames_num = feature.shape[1]
        num_starts = max(frames_num - crop_size, 0)
        possible = np.arange(frame_index, frame_index + num_starts)
        frame_index += frames_num

        features_list.append(feature)
        event_list.append(event_matrix)

        flags = classify_start_indices(event_matrix, num_starts, crop_size)
        idx_with_event.append(possible[flags])
        idx_empty.append(possible[~flags])

    features = np.concatenate(features_list, axis=1)
    event_matrix = np.concatenate(event_list, axis=0)

    with_event = np.concatenate(idx_with_event) if idx_with_event else np.array([], np.int64)
    empty = np.concatenate(idx_empty) if idx_empty else np.array([], np.int64)
    rng.shuffle(with_event)
    rng.shuffle(empty)
    if balance_classes:
        size = min(len(with_event), len(empty))
        with_event = with_event[:size]
        empty = empty[:size]
    start_indices = np.concatenate((empty, with_event))
    rng.shuffle(start_indices)
    return PackedTrainData(features, event_matrix, start_indices.astype(np.int32))


def read_validation_data_to_memory(feature_paths, cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM):
    """Reference _read_validation_data_to_memory (spectograms_dataset.py:190-202)."""
    features_list, event_list = [], []
    for feature_path in feature_paths:
        with open(feature_path, "rb") as f:
            data = pickle.load(f)
        features_list.append(data["features"])
        event_list.append(
            create_event_matrix(data["features"].shape[1], data["start_times"],
                                data["end_times"], cfg,
                                class_indices=data.get("class_indices"))
        )
    return features_list, event_list


class SpectrogramDataset:
    """Packed crop dataset with reference-parity sampling and transforms.

    Reference: SpectogramDataset (spectograms_dataset.py:17-135).
    """

    def __init__(
        self,
        features_and_labels_dir: str,
        mean_std_file: str,
        val_descriptor,
        balance_classes: bool = False,
        augment_data: bool = False,
        preprocessed_mode: str = "Complex",
        cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
        seed: Optional[int] = None,
    ):
        assert preprocessed_mode in ("logMel", "Complex"), \
            "Spectogram type should be either logMel or Complex"
        assert not (preprocessed_mode == "logMel" and augment_data), \
            "Can't perform augmentation in logMel spectograms"
        self.cfg = cfg
        self.preprocessed_mode = preprocessed_mode
        self.augment_data = augment_data
        self.train_crop_size = cfg.train_crop_size
        self._rng = np.random.default_rng(seed)

        with open(mean_std_file, "rb") as f:
            d = pickle.load(f)
        self.mean = d["mean"]
        self.std = d["std"]

        all_paths = sorted(
            os.path.join(features_and_labels_dir, x)
            for x in os.listdir(features_and_labels_dir)
        )
        # Substring descriptors match the pickle FILENAME, not the full path:
        # the reference matches full paths (spectograms_dataset.py:269-276),
        # so a descriptor colliding with a directory component (e.g. 's_2'
        # inside 'Tau_sound_events_2019') routes EVERY file to validation —
        # a reference defect, fixed (PARITY.md divergence #1).  All pickles
        # live flat in one directory, so the basename carries the recording
        # identity the descriptor is meant to select.
        train_paths, self.val_feature_paths = split_train_val(
            all_paths, val_descriptor, key=os.path.basename, seed=seed
        )
        packed = read_train_data_to_memory(
            train_paths, cfg.train_crop_size, balance_classes, cfg, self._rng
        )
        self.train_features = packed.features
        self.train_event_matrix = packed.event_matrix
        self.train_start_indices = packed.start_indices
        self.val_features_list, self.val_event_matrix_list = read_validation_data_to_memory(
            self.val_feature_paths, cfg
        )

        val_frames = (
            len(np.concatenate(self.val_event_matrix_list, axis=0))
            if self.val_event_matrix_list else 0
        )
        print(
            f"Data generator initiated with {len(train_paths)} train samples "
            f"totaling {len(self.train_event_matrix) / cfg.frames_per_second:.1f} seconds "
            f"and {len(self.val_feature_paths)} val samples "
            f"totaling {val_frames / cfg.frames_per_second:.1f} seconds"
        )

    def __len__(self) -> int:
        return len(self.train_start_indices)

    # -- host-side reference path (used by tests and small-scale runs) -------

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Normalize; in Complex mode convert to log-mel *after* normalization
        (reference quirk, spectograms_dataset.py:104-110).

        Host-side numpy, with complex inputs (the device pipeline uses the
        stacked real/imag representation instead); the dB step is the
        port's ``power_to_db`` on a CPU tensor.
        """
        x = (x - self.mean) / self.std
        if self.preprocessed_mode == "logMel":
            return x
        import torch

        from sed_tpu_torch.ops.mel import mel_filterbank, power_to_db

        power = np.abs(x).astype(np.float32) ** 2
        mel = power @ mel_filterbank(self.cfg)
        return power_to_db(torch.from_numpy(np.asarray(mel, np.float32))).numpy()

    def get_item(self, idx: int):
        """Host-side crop fetch (reference __getitem__, spectograms_dataset.py:58-78),
        without augmentation (the device pipeline owns augmentation)."""
        sl = slice(self.train_start_indices[idx], self.train_start_indices[idx] + self.train_crop_size)
        features = self.train_features[:, sl]
        event_matrix = self.train_event_matrix[sl]
        return self.transform(features), event_matrix

    def get_validation_sampler(self, max_validate_num: Optional[int] = None):
        """Whole recordings, one at a time, batch dim 1
        (reference: spectograms_dataset.py:80-102)."""
        for n in range(len(self.val_feature_paths)):
            if n == max_validate_num:
                break
            name = os.path.basename(os.path.splitext(self.val_feature_paths[n])[0])
            feature = self.transform(self.val_features_list[n])
            event_matrix = self.val_event_matrix_list[n]
            yield feature[None], event_matrix[None], name

    def epoch_start_indices(self, batch_size: int, drop_last: bool = True):
        """One epoch of start-index batches in the stored shuffled order
        (the reference's DataLoader iterates the pre-shuffled indices without
        reshuffling, main.py:125)."""
        n = len(self.train_start_indices)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            yield self.train_start_indices[i:i + batch_size]


# ---------------------------------------------------------------------------
# Dataset prep orchestrators (reference: spectograms_dataset.py:221-261)
# ---------------------------------------------------------------------------

def preprocess_tau_sed_data(
    data_dir: str,
    preprocess_mode: str,
    force_preprocess: bool = False,
    fold_name: str = "eval",
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    workers: int = 0,
    device="cuda",
    plot_sample: bool = True,
):
    """Download/extract/preprocess TAU-SED; returns (features_dir, mean_std_file).
    Features are computed on ``device``.

    The reference appends the class list to a mutable module-global descriptor
    (spectograms_dataset.py:226) and has a stale module path at :231 that makes
    it crash; here the descriptor is computed functionally and the path fixed.
    """
    descriptor = cfg.cfg_descriptor + f"_C-{'-'.join(cfg.tau_sed_labels)}"
    ambisonic_dir = os.path.join(data_dir, "Tau_sound_events_2019")
    audio_dir, meta_data_dir = ensure_tau_data(ambisonic_dir, fold_name=fold_name)

    processed_dir = os.path.join(ambisonic_dir, "processed", descriptor)
    features_dir = f"{processed_dir}/{preprocess_mode}-features_and_labels_{fold_name}"
    mean_std_file = f"{processed_dir}/{preprocess_mode}-features_mean_std_{fold_name}.pkl"
    if not os.path.exists(features_dir) or force_preprocess:
        from sed_tpu_torch.data.preprocess import preprocess_data

        paths_and_labels = get_tau_sed_paths_and_labels(audio_dir, meta_data_dir, cfg)
        os.makedirs(processed_dir, exist_ok=True)
        preprocess_data(paths_and_labels, output_dir=features_dir,
                        output_mean_std_file=mean_std_file,
                        preprocess_mode=preprocess_mode, cfg=cfg,
                        workers=workers, device=device, plot_sample=plot_sample)
    else:
        print("Using existing mel features")
    return features_dir, mean_std_file


def preprocess_film_clap_data(
    data_dir: str,
    preprocessed_mode: str,
    force_preprocess: bool = False,
    cfg: SpectrogramConfig = DEFAULT_SPECTROGRAM,
    workers: int = 0,
    device="cuda",
    plot_sample: bool = True,
):
    """FilmClap orchestration (reference: spectograms_dataset.py:243-261).
    Features are computed on ``device``."""
    film_clap_dir = os.path.join(data_dir, "FilmClap")
    descriptor = cfg.cfg_descriptor + f"_tm-{cfg.time_margin}"
    if not os.path.exists(film_clap_dir):
        raise FileNotFoundError("You should get your own dataset...")
    features_dir = f"{film_clap_dir}/processed/{descriptor}/{preprocessed_mode}-features_and_labels"
    mean_std_file = f"{film_clap_dir}/processed/{descriptor}/{preprocessed_mode}-features_mean_std.pkl"
    if not os.path.exists(features_dir) or force_preprocess:
        from sed_tpu_torch.data.preprocess import preprocess_data

        print("preprocessing raw data")
        paths_and_labels = get_film_clap_paths_and_labels(film_clap_dir, time_margin=cfg.time_margin)
        preprocess_data(paths_and_labels, output_dir=features_dir,
                        output_mean_std_file=mean_std_file,
                        preprocess_mode=preprocessed_mode, cfg=cfg,
                        workers=workers, device=device, plot_sample=plot_sample)
    else:
        print("Using existing mel features")
    return features_dir, mean_std_file
