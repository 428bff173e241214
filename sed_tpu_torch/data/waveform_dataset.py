"""Waveform crop dataset: packed sample buffer + per-start-index labels
(counterpart of ``sed_tpu.data.waveform_dataset``).

Reference: dataset/waveform/waveform_dataset.py:46-158.  All training
waveforms are concatenated into one (channels, samples) buffer; a training
item is a frame_size crop at a random legal start index whose label comes
from an analytically precomputed per-start-index boolean array.  Validation
recordings are pre-split into hop-strided frames with coverage labels.

The packed buffer is uploaded to the device once
(``data.device_pipeline.waveform_buffers_from_dataset``) and the crops are
gathered in the train step, so the host only sends start indices.  The host
draws (split, balance, shuffle) are ``sed_tpu``'s, from the same seeded numpy
generator in the same order, so both packages train on the same batches.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from sed_tpu_torch.configs import DEFAULT_WAVEFORM, WaveformConfig
from sed_tpu_torch.data.events import frame_coverage_labels, start_index_labels
from sed_tpu_torch.data.split import split_train_val
from sed_tpu_torch.io.audio import read_multichannel_audio_batch
from sed_tpu_torch.io.labels import event_class_indices


class WaveformDataset:
    def __init__(
        self,
        audio_paths_labels_and_names,
        val_descriptor=0.15,
        balance_classes: bool = False,
        augment_data: bool = False,
        cfg: WaveformConfig = DEFAULT_WAVEFORM,
        seed: Optional[int] = None,
        workers: int = 0,
    ):
        self.cfg = cfg
        self.balance_classes = balance_classes
        self.augment_data = augment_data
        rng = np.random.default_rng(seed)

        print("WaveformDataset:")
        print("\t- Loading samples into memory... ")
        train_items, val_items = split_train_val(
            audio_paths_labels_and_names, val_descriptor,
            key=lambda item: item[0], seed=seed,
        )

        # classes_num > 1 labels each crop with a per-class vector; that needs
        # per-event class identity (LabeledAudio from the TAU parser): the
        # class-blind union label would train every class column identically.
        multiclass = cfg.classes_num > 1

        def _classes(item):
            cls = event_class_indices(item)
            if multiclass and cls is None:
                raise ValueError(
                    f"classes_num={cfg.classes_num} requires per-event class "
                    f"identity on every item (io.labels.LabeledAudio); "
                    f"{item[3]!r} has none"
                )
            return cls if multiclass else None

        def _load_all(items):
            # workers > 1: decode + resample on the native reader's threads,
            # equal at the working rate; resampled sources cross from scipy's
            # resampler to the reader's, the same Kaiser design.
            return read_multichannel_audio_batch(
                [it[0] for it in items], target_fs=cfg.working_sample_rate, cfg=cfg,
                workers=workers)

        waveforms: List[np.ndarray] = []
        start_labels: List[np.ndarray] = []
        start_indices: List[np.ndarray] = []
        frame_index = 0
        for item, waveform in zip(train_items, _load_all(train_items)):
            audio_path, start_times, end_times, _name = item
            waveform = waveform.T.astype(np.float32)  # (channels, samples)
            waveforms.append(waveform)
            # Crops must not straddle two recordings (waveform_dataset.py:71-74).
            possible = np.arange(
                frame_index, frame_index + waveform.shape[1] - cfg.frame_size, dtype=np.int64
            )
            start_indices.append(possible)
            frame_index += waveform.shape[1]
            start_labels.append(
                start_index_labels(waveform.shape[1], start_times, end_times, cfg,
                                   class_indices=_classes(item))
            )

        empty_labels = (
            np.zeros((0, cfg.classes_num), bool) if multiclass else np.zeros(0, bool)
        )
        self.long_waveform = (
            np.concatenate(waveforms, axis=1) if waveforms
            else np.zeros((cfg.audio_channels, 0), np.float32)
        )
        self.all_start_indices_labels = (
            np.concatenate(start_labels) if start_labels else empty_labels
        )
        possible_all = (
            np.concatenate(start_indices) if start_indices else np.zeros(0, np.int64)
        )

        if balance_classes and possible_all.size:
            # The reference exposes the flag but never uses it in this
            # dataset; it is honoured here as in sed_tpu: empty starts are
            # subsampled to the number of event starts (a start is an event
            # start when any class is active there).
            labels = self.all_start_indices_labels[possible_all]
            if labels.ndim > 1:
                labels = labels.any(axis=1)
            pos = possible_all[labels]
            neg = possible_all[~labels]
            rng.shuffle(pos)
            rng.shuffle(neg)
            size = min(len(pos), len(neg))
            possible_all = np.concatenate((neg[:size], pos[:size]))

        rng.shuffle(possible_all)
        if possible_all.size and int(possible_all.max()) >= 2**31:
            raise ValueError(
                "concatenated training audio exceeds 2^31 samples (~12.4 h at "
                "48 kHz); shard the corpus across data-parallel processes or "
                "split the packed buffer before training"
            )
        self.possible_start_indices = possible_all.astype(np.int32)

        # Validation: hop-strided frames + coverage labels (waveform_dataset.py:89-98).
        self.val_samples_sets, self.val_label_sets, self.val_file_names = [], [], []
        for item, waveform in zip(val_items, _load_all(val_items)):
            audio_path, start_times, end_times, audio_name = item
            waveform = waveform.T.astype(np.float32)
            frames, labels = frame_coverage_labels(waveform, start_times, end_times, cfg,
                                                   class_indices=_classes(item))
            self.val_samples_sets.append(frames)
            self.val_label_sets.append(labels)
            self.val_file_names.append(audio_name)

        def _any_class(x):
            return x.any(axis=-1) if x.ndim > 1 else x

        n = len(self.possible_start_indices)
        if n:
            tagged = _any_class(self.all_start_indices_labels[self.possible_start_indices])
            print(f"\t- Train split: {n} overlapping frames. "
                  f"~{100 * np.sum(tagged) / n:.1f}% tagged as event")
        print(
            f"\t- Val split: {sum(len(x) for x in self.val_label_sets)} frames. "
            f"{sum(int(np.sum(_any_class(x))) for x in self.val_label_sets)} tagged as event"
        )

    def __len__(self) -> int:
        return len(self.possible_start_indices)

    def get_item(self, idx: int):
        """Host-side crop fetch (reference __getitem__, waveform_dataset.py:112-122),
        without augmentation (the device pipeline's)."""
        start = self.possible_start_indices[idx]
        waveform = self.long_waveform[:, start:start + self.cfg.frame_size]
        label = self.all_start_indices_labels[start]
        return waveform, label

    def get_validation_sampler(self, max_validate_num: Optional[int] = None):
        """Yield (frames, labels, name) per validation recording.

        The reference breaks when ``i > max_validate_num`` (an off-by-one that
        yields one extra recording against the spectrogram sampler,
        waveform_dataset.py:105); this keeps the spectrogram sampler's
        exact limit, as ``sed_tpu`` does.
        """
        for i, (frames, labels, name) in enumerate(
            zip(self.val_samples_sets, self.val_label_sets, self.val_file_names)
        ):
            if i == max_validate_num:
                break
            yield frames, labels.astype(np.float32), name

    def epoch_start_indices(self, batch_size: int, drop_last: bool = True):
        n = len(self.possible_start_indices)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            yield self.possible_start_indices[i:i + batch_size]
