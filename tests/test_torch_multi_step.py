"""K train steps in one call, and the profiler window of train(), on the CPU.

``make_multi_step`` against K single calls from one state and one generator
seed: losses, parameters, BatchNorm statistics and optimizer moments equal
bit for bit, with and without augmentation, for M5 and CnnAvgPooling.
train()'s refusals for steps_per_call are sed_tpu's, message for message;
train(steps_per_call=K) equals train() with single steps bit for bit; the
profile_dir trace holds the step's ranges.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu.train import loop as jax_loop
from sed_tpu_torch.cli import main as cli_main
from sed_tpu_torch.configs import DEFAULT_WAVEFORM, SpectrogramConfig, WaveformConfig
from sed_tpu_torch.data import device_pipeline as pipe
from sed_tpu_torch.models.cnn import CnnAvgPooling
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.train import loop
from sed_tpu_torch.train.state import init_state

CFG = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
WCFG = WaveformConfig(working_sample_rate=8000, time_margin=0.33)
SMALL = ((8, 2), (16, 2))
K = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _SpectrogramStore:
    """A packed spectrogram training split and validation set, as
    SpectrogramDataset holds them."""

    def __init__(self, seed=0, frames=400):
        rng = np.random.default_rng(seed)
        self.train_features = rng.standard_normal((1, frames, CFG.mel_bins)).astype(np.float32)
        self.train_event_matrix = (rng.random((frames, 1)) > 0.7).astype(np.float32)
        self.train_start_indices = rng.permutation(frames - CFG.train_crop_size).astype(np.int32)
        self.mean = self.train_features.mean(axis=(0, 1))
        self.std = self.train_features.std(axis=(0, 1))
        self.val = (rng.standard_normal((1, 1, 40, CFG.mel_bins)).astype(np.float32),
                    (rng.random((1, 40, 1)) > 0.7).astype(np.float32))

    def __len__(self):
        return len(self.train_start_indices)

    def epoch_start_indices(self, batch_size, drop_last=True):
        n = len(self) - len(self) % batch_size
        for i in range(0, n, batch_size):
            yield self.train_start_indices[i:i + batch_size]

    def get_validation_sampler(self, max_validate_num=None):
        yield self.val[0], self.val[1], "val_0"


class _WaveformStore:
    """A packed waveform training split and validation set, as
    WaveformDataset holds them."""

    def __init__(self, seed=0, samples=4 * WCFG.frame_size):
        rng = np.random.default_rng(seed)
        self.long_waveform = (0.1 * rng.standard_normal((1, samples))).astype(np.float32)
        self.all_start_indices_labels = rng.random(samples) > 0.8
        self.possible_start_indices = rng.permutation(samples - WCFG.frame_size).astype(np.int32)
        self.val = (rng.standard_normal((3, 1, WCFG.frame_size)).astype(np.float32),
                    np.array([0, 1, 0], np.float32))

    def __len__(self):
        return len(self.possible_start_indices)

    def epoch_start_indices(self, batch_size, drop_last=True):
        n = len(self) - len(self) % batch_size
        for i in range(0, n, batch_size):
            yield self.possible_start_indices[i:i + batch_size]

    def get_validation_sampler(self, max_validate_num=None):
        yield self.val[0], self.val[1], "val_0"


def family(name, augment):
    """(store, buffers, step, a fresh seeded model) of one model family."""
    if name == "M5":
        store = _WaveformStore()
        bufs = pipe.waveform_buffers_from_dataset(store, "cpu")
        step = pipe.make_waveform_train_step(WCFG, 5.0, augment=augment)
        return store, bufs, step, lambda: M5(1, generator=torch.Generator().manual_seed(0))
    store = _SpectrogramStore()
    bufs = pipe.spectrogram_buffers_from_dataset(store, "cpu")
    step = pipe.make_spectrogram_train_step(CFG, 5.0, augment=augment)
    return store, bufs, step, lambda: CnnAvgPooling(1, SMALL,
                                                    generator=torch.Generator().manual_seed(0))


def assert_states_equal(a, b):
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k]), k
    assert a.step == b.step and a.scheduler.last_epoch == b.scheduler.last_epoch


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("name", ["M5", "CnnAvgPooling"])
def test_multi_step_equals_single_steps(name, augment):
    store, bufs, step, fresh = family(name, augment)
    batches = list(store.epoch_start_indices(4))[:2 * K]
    multi = pipe.make_multi_step(step, K)

    single = init_state(fresh(), 1e-3, "cpu")
    gen = torch.Generator().manual_seed(7)
    want = [step(single, bufs, s, gen) for s in batches]

    blocked = init_state(fresh(), 1e-3, "cpu")
    gen = torch.Generator().manual_seed(7)
    got = [multi(blocked, bufs, np.stack(batches[i:i + K]), gen)
           for i in range(0, len(batches), K)]
    assert all(g.shape == (K,) for g in got)
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert_states_equal(blocked, single)
    with pytest.raises(ValueError, match=r"\(4, batch\)"):
        multi(blocked, bufs, np.stack(batches[:K - 1]), gen)


@pytest.mark.parametrize("kw,resumed_step", [
    ({"num_steps": 6, "log_freq": 4}, None),
    ({"num_steps": 8, "log_freq": 6}, None),
    ({"num_steps": 8, "log_freq": 4}, 2),
])
def test_steps_per_call_refusals_match_sed_tpu(tmp_path, kw, resumed_step):
    """Both packages refuse before any work, with the same message."""
    class Resumed:
        step = resumed_step

    initial = None if resumed_step is None else Resumed()
    messages = []
    for train, extra in ((loop.train, {"device": "cpu"}), (jax_loop.train, {})):
        with pytest.raises(ValueError) as e:
            train(None, None, "spectogram", lr=1e-3, outputs_dir=str(tmp_path / "out"),
                  steps_per_call=K, initial_state=initial, **kw, **extra)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert "steps_per_call" in messages[0]


@pytest.mark.parametrize("name", ["M5", "CnnAvgPooling"])
def test_train_steps_per_call_equals_single_steps(tmp_path, name):
    store, _, _, fresh = family(name, False)
    kw = dict(num_steps=8, lr=1e-3, log_freq=4, batch_size=4, make_plots=False,
              device="cpu", cfg=WCFG if name == "M5" else CFG)
    mode = "waveform" if name == "M5" else "spectogram"
    runs = {}
    for k in (1, K):
        runs[k] = loop.train(fresh(), store, mode, outputs_dir=str(tmp_path / str(k)),
                             steps_per_call=k, seed=0,
                             initial_state=init_state(fresh(), 1e-3, "cpu"), **kw)
    assert_states_equal(runs[K], runs[1])
    recs = [[json.loads(line) for line in open(tmp_path / str(k) / "metrics.jsonl")]
            for k in (1, K)]
    assert [r["iteration"] for r in recs[1]] == [4, 8]
    assert [r["train_loss"] for r in recs[0]] == [r["train_loss"] for r in recs[1]]
    assert sorted(os.listdir(tmp_path / str(K) / "checkpoints")) == \
        ["iteration_4.pt", "iteration_8.pt"]


@pytest.mark.parametrize("steps_per_call,window", [(1, (10, 20)), (K, (12, 20))])
def test_profile_dir_writes_a_trace_of_steps_10_to_20(tmp_path, steps_per_call, window):
    store, _, _, fresh = family("CnnAvgPooling", False)
    prof = tmp_path / "prof"
    loop.train(fresh(), store, "spectogram", num_steps=24, lr=1e-3, log_freq=24,
               outputs_dir=str(tmp_path / "out"), batch_size=4, cfg=CFG, make_plots=False,
               profile_dir=str(prof), steps_per_call=steps_per_call, device="cpu")
    (name,) = os.listdir(prof)
    assert name == f"train_steps_{window[0]}-{window[1]}.json"
    with open(prof / name) as f:
        trace = json.load(f)
    names = [e.get("name") for e in trace["traceEvents"]]
    # One range a step in the window (the K-step call runs K steps).
    assert names.count("train_step/forward") == window[1] - window[0]
    assert names.count("train_step/backward") == window[1] - window[0]


def test_profile_dir_of_a_run_that_ends_inside_the_window(tmp_path):
    store, _, _, fresh = family("M5", False)
    loop.train(fresh(), store, "waveform", num_steps=12, lr=1e-3, log_freq=12,
               outputs_dir=str(tmp_path / "out"), batch_size=2, cfg=WCFG, make_plots=False,
               profile_dir=str(tmp_path / "prof"), device="cpu")
    assert os.listdir(tmp_path / "prof") == ["train_steps_10-12.json"]


@pytest.fixture(scope="module")
def film_clap_root(tmp_path_factory):
    """A FilmClap-layout corpus: 3 x 4 s clips at 48 kHz, one tonal burst each."""
    root = tmp_path_factory.mktemp("film")
    film_dir = root / "FilmClap" / "filmA"
    film_dir.mkdir(parents=True)
    rng = np.random.default_rng(2)
    sr = DEFAULT_WAVEFORM.working_sample_rate
    labels = {}
    for i in range(3):
        sig = 0.01 * rng.standard_normal(4 * sr)
        t = np.arange(sr) / sr
        sig[sr:2 * sr] += 0.5 * np.sin(2 * np.pi * 2000 * t)
        path = str(film_dir / f"clip_{i}.wav")
        wavfile.write(path, sr, sig.astype(np.float32))
        labels[path] = [1.33, 1.66]
    with open(root / "FilmClap" / "paths_and_labels_fixed_Meron.txt", "w") as f:
        json.dump(labels, f)
    return str(root)


def test_train_cli_steps_per_call_and_profile_dir(film_clap_root, tmp_path):
    """The CLI's defaults (Waveform, M5) with --steps_per_call 4 and
    --profile_dir: 20 steps in five calls, one trace of steps 12-20."""
    outputs_root = str(tmp_path / "training")
    cli_main.main(["--dataset_dir", film_clap_root, "--outputs_root", outputs_root,
                   "--val_descriptor", "clip_2", "--batch_size", "2", "--num_train_steps", "20",
                   "--log_freq", "20", "--steps_per_call", "4", "--profile_dir",
                   str(tmp_path / "prof"), "--device", "cpu", "--no_plot"])
    (run,) = os.listdir(outputs_root)
    assert os.listdir(os.path.join(outputs_root, run, "checkpoints")) == ["iteration_20.pt"]
    assert os.listdir(tmp_path / "prof") == ["train_steps_12-20.json"]
    saved = torch.load(os.path.join(outputs_root, run, "checkpoints", "iteration_20.pt"),
                       weights_only=True)
    assert saved["step"] == 20 and int(saved["optimizer"]["state"][0]["step"]) == 20
