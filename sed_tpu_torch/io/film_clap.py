"""FilmClap clapperboard dataset label parsing (counterpart of
``sed_tpu.io.film_clap``).

Reference: dataset/dataset_utils.py:13-39 — a JSON file maps audio paths to
lists of event-center times; start/end = center -/+ time_margin.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

from sed_tpu_torch.io.labels import LabeledAudio

LABEL_FILE = "paths_and_labels_fixed_Meron.txt"


def get_film_clap_paths_and_labels(data_root: str, time_margin: float = 0.1):
    result = []
    num_claps = 0
    num_audio_files = 0
    files_per_film = defaultdict(int)
    with open(os.path.join(data_root, LABEL_FILE)) as f:
        path_to_label = json.load(f)
    print("Collecting Film-clap dataset")
    for sound_path, event_centers in path_to_label.items():
        soundfile_name = os.path.splitext(os.path.basename(sound_path))[0]
        film_name = os.path.basename(os.path.dirname(sound_path))
        name = f"{film_name}_{soundfile_name}"
        if not os.path.exists(sound_path):
            raise FileNotFoundError(sound_path)
        start_times = [e - time_margin for e in event_centers]
        end_times = [e + time_margin for e in event_centers]
        # FilmClap is single-class (every event is a clap): class index 0.
        result.append(LabeledAudio(sound_path, start_times, end_times, name,
                                   [0] * len(start_times)))
        num_claps += len(start_times)
        num_audio_files += 1
        files_per_film[film_name] += 1

    for film_name, count in files_per_film.items():
        print(f"\t- {film_name} has {count}")
    print(f"\tFilm clap dataset contains {num_audio_files} audio files with {num_claps} clap incidents")
    return result
