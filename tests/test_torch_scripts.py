"""The port's exploration scripts (``sed_tpu_torch/scripts``) against the
root scripts' computations in ``sed_tpu``, on the CPU.

  * ``analyze_spectogram``: the features within 1e-4 dB of ``sed_tpu``'s
    ``logmel_features`` on the same segment of a synthetic WAV, the segment
    written equal, and the root script's summary line;
  * ``plot_waveform_frames``: the positive crops equal ``sed_tpu``'s
    ``WaveformDataset``'s;
  * ``play_with_spectograms``: the same held-out accuracy as the root
    script on a seeded separable set (each run on its own copy of the
    corpus, as both cache their features under it).
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import analyze_spectogram as root_analyze
import play_with_spectograms as root_play
from sed_tpu.configs import DEFAULT_SPECTROGRAM as JCFG
from sed_tpu.configs import DEFAULT_WAVEFORM as JWCFG
from sed_tpu.data.waveform_dataset import WaveformDataset as JaxWaveformDataset
from sed_tpu.io.audio import read_multichannel_audio as jax_read
from sed_tpu.io.audio import write_wav as jax_write_wav
from sed_tpu.io.film_clap import get_film_clap_paths_and_labels as jax_film_clap
from sed_tpu.ops.featurizer import logmel_features as jax_logmel_features
from sed_tpu_torch.io.film_clap import LABEL_FILE
from sed_tpu_torch.scripts import analyze_spectogram, play_with_spectograms
from sed_tpu_torch.scripts import plot_waveform_frames

SR = 48000
DB_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def film_clap(root, files, seconds, seed=0):
    """FilmClap layout: mono 48 kHz WAVs of faint noise with a loud 2 kHz
    burst of 1.5 s every 5 s, labelled by centres 0.33 s apart along it."""
    rng = np.random.default_rng(seed)
    film = root / "FilmClap" / "film"
    film.mkdir(parents=True)
    labels = {}
    n = int(seconds * SR)
    for i in range(files):
        x = 0.01 * rng.standard_normal(n)
        centers = []
        for start in np.arange(1.0, seconds - 2.0, 5.0):
            a = int(start * SR)
            t = np.arange(int(1.5 * SR)) / SR
            x[a:a + len(t)] += 0.5 * np.sin(2 * np.pi * 2000 * t)
            centers += [float(c) for c in np.arange(start + 0.33, start + 1.5 - 0.33 + 1e-9, 0.33)]
        path = str(film / f"clip_{i}.wav")
        wavfile.write(path, SR, (x * 32767).astype(np.int16))
        labels[path] = centers
    with open(root / "FilmClap" / LABEL_FILE, "w") as f:
        json.dump(labels, f)
    return root


def test_analyze_spectogram_matches_sed_tpu(tmp_path, capsys):
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    x = 0.1 * rng.standard_normal(len(t)) + 0.3 * np.sin(2 * np.pi * 1000 * t)
    wav = str(tmp_path / "a.wav")
    wavfile.write(wav, SR, (x * 32767).astype(np.int16))
    out = tmp_path / "analysis.png"
    seg = str(tmp_path / "seg.wav")
    feature = analyze_spectogram.main([wav, "--sec_start", "0.5", "--sec_end", "2.5",
                                       "--out", str(out), "--save_segment", seg,
                                       "--device", "cpu", "--no_plot"])
    said = capsys.readouterr().out
    saved = np.load(tmp_path / "analysis.npz")
    assert not out.exists()
    wave = jax_read(wav, target_fs=JCFG.working_sample_rate, cfg=JCFG)[int(0.5 * SR):int(2.5 * SR)]
    want = np.asarray(jax_logmel_features(wave.astype(np.float32), JCFG))
    assert feature.shape == want.shape == saved["feature"].shape
    np.testing.assert_allclose(saved["feature"], want, rtol=0, atol=DB_TOL)
    np.testing.assert_array_equal(saved["waveform"], wave)
    assert said.strip() == f"wrote {tmp_path / 'analysis.npz'}; feature shape {want.shape}"
    jax_write_wav(str(tmp_path / "seg_ref.wav"), wave[:, 0], SR)
    assert (tmp_path / "seg.wav").read_bytes() == (tmp_path / "seg_ref.wav").read_bytes()

    root_analyze.main([wav, "--sec_start", "0.5", "--sec_end", "2.5", "--out",
                       str(tmp_path / "root.png")])
    root_said = capsys.readouterr().out
    analyze_spectogram.main([wav, "--sec_start", "0.5", "--sec_end", "2.5", "--out",
                             str(out), "--device", "cpu"])
    port_said = capsys.readouterr().out
    assert out.exists() and (tmp_path / "root.png").exists()
    assert port_said.replace(str(out), "X") == root_said.replace(str(tmp_path / "root.png"), "X")


def test_plot_waveform_frames_equal_sed_tpus_dataset(tmp_path, capsys):
    root = film_clap(tmp_path / "data", files=3, seconds=8.0)
    out = tmp_path / "debug"
    indices, frames = plot_waveform_frames.main([
        "--dataset_dir", str(root), "--out_dir", str(out), "--num_frames", "6",
        "--device", "cpu", "--no_plot"])
    assert f"wrote 6 positive frames to {out}/" in capsys.readouterr().out
    saved = np.load(out / plot_waveform_frames.NPZ_NAME)
    items = jax_film_clap(str(root / "FilmClap"), JWCFG.time_margin)
    theirs = JaxWaveformDataset(items, val_descriptor=0.0, cfg=JWCFG, seed=0)
    want_idx, want = [], []
    for i in range(len(theirs)):
        frame, label = theirs.get_item(i)
        if label:
            want_idx.append(i)
            want.append(np.asarray(frame))
        if len(want) == 6:
            break
    assert indices == want_idx == saved["indices"].tolist()
    np.testing.assert_array_equal(saved["frames"], np.stack(want))
    assert saved["frames"].shape == (6, JWCFG.audio_channels, JWCFG.frame_size)


def test_play_with_spectograms_matches_the_root_script(tmp_path, capsys):
    ours = film_clap(tmp_path / "ours", files=5, seconds=21.0)
    theirs = tmp_path / "theirs"
    shutil.copytree(ours, theirs)
    with open(theirs / "FilmClap" / LABEL_FILE) as f:
        labels = {p.replace(str(ours), str(theirs)): c for p, c in json.load(f).items()}
    with open(theirs / "FilmClap" / LABEL_FILE, "w") as f:
        json.dump(labels, f)
    args = ["--holdout", "20", "--seed", "0", "--val_descriptor", "0.2"]
    root_play.main(["--dataset_dir", str(theirs), *args])
    want = re.search(r"held-out accuracy: (\S+)", capsys.readouterr().out).group(1)
    acc = play_with_spectograms.main(["--dataset_dir", str(ours), *args, "--device", "cpu",
                                      "--no_plot"])
    got = re.search(r"held-out accuracy: (\S+)", capsys.readouterr().out).group(1)
    assert got == want and float(got) == acc
    assert acc >= 0.9
