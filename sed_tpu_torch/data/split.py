"""Train/validation splitting (counterpart of ``sed_tpu.data.split``; the same
seeded numpy draw, so both packages split alike).

Reference keeps two near-identical copies (spectograms_dataset.py:264-280 and
waveform_dataset.py:142-158); both semantics live here: a float descriptor
means "shuffle, first fraction is validation"; a string descriptor routes
items whose key contains the substring to validation.
"""

from __future__ import annotations

import numpy as np


def split_train_val(items, val_descriptor, key=lambda item: item, seed=None):
    """Split ``items`` into (train, validation).

    ``key`` extracts the string matched against a substring descriptor (the
    spectrogram variant matches file paths, the waveform variant matches
    ``tuple[0]`` — pass the appropriate key).
    """
    items = list(items)
    if isinstance(val_descriptor, float):
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(items))
        items = [items[i] for i in order]
        val_split = int(len(items) * val_descriptor)
        return items[val_split:], items[:val_split]

    train_items, val_items = [], []
    for item in items:
        if val_descriptor in key(item):
            val_items.append(item)
        else:
            train_items.append(item)
    return train_items, val_items
