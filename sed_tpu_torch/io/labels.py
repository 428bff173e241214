"""Per-recording label carrier shared by the dataset parsers (counterpart of
``sed_tpu.io.labels``, the port's own copy).

The reference passes labels around as plain 4-tuples
``(audio_path, start_times, end_times, name)`` and discards each event's
class identity at parse time.  :class:`LabeledAudio` IS that 4-tuple --
iteration and indexing are unchanged -- extended with a ``class_indices``
attribute carrying each event's index into ``cfg.tau_sed_labels`` (None when
the source has no class identity, e.g. reference-era caches).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class LabeledAudio(tuple):
    """(audio_path, start_times, end_times, name) + per-event class indices.

    Unpacks as the reference 4-tuple; multiclass-aware consumers read
    ``item.class_indices`` (or ``getattr(item, "class_indices", None)`` for
    inputs that may be plain tuples).
    """

    class_indices: Optional[np.ndarray]

    def __new__(cls, audio_path: str, start_times, end_times, name: str,
                class_indices: Optional[Sequence[int]] = None):
        self = super().__new__(cls, (audio_path, start_times, end_times, name))
        self.class_indices = (
            None if class_indices is None
            else np.asarray(class_indices, dtype=np.int64)
        )
        if self.class_indices is not None and \
                len(self.class_indices) != len(start_times):
            raise ValueError(
                f"class_indices has {len(self.class_indices)} entries for "
                f"{len(start_times)} events in {name}"
            )
        return self

    @property
    def audio_path(self) -> str:
        return self[0]

    @property
    def start_times(self):
        return self[1]

    @property
    def end_times(self):
        return self[2]

    @property
    def name(self) -> str:
        return self[3]


def event_class_indices(item) -> Optional[np.ndarray]:
    """Per-event class indices of a parser item, or None for class-blind
    sources (plain tuples, FilmClap, reference-era caches)."""
    return getattr(item, "class_indices", None)
