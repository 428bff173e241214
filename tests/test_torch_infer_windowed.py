"""The windowed per-file path and the other archs of the inference CLI
against sed_tpu's (CPU).

``predict_file`` (CnnAvgPooling, MobileNetV1) and ``predict_file_m5`` are
held against ``sed_tpu.cli.infer``'s on the same weights (flax trees with
every scale, bias and BN statistic drawn from a seed, carried over by
``models.convert``) and the same WAV, with windows small enough for several
windows and a ragged tail.  The CLI runs end to end for each ``--arch`` from
``.pth`` files written by ``sed_tpu.train.torch_export``, beside
``sed_tpu``'s CLI on the msgpack checkpoint of the same weights.  Also the
helpers ported with the slice: ``write_wav``,
``read_multichannel_audio_batch``, ``event_dict``, ``human_format`` and
``cfg_descriptor``.

Tolerance: scores within 1e-5 abs of ``sed_tpu``'s, the same frame counts;
the CSVs' values within 1e-5 (they hold 6 decimals); everything else equal.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu import configs as jax_configs
from sed_tpu.cli import infer as jax_cli
from sed_tpu.io import audio as jax_audio
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.models.cnn import MobileNetV1 as FlaxMobileNetV1
from sed_tpu.models.m5 import M5 as FlaxM5
from sed_tpu.utils import events_post as jax_events_post
from sed_tpu_torch import configs
from sed_tpu_torch.cli import infer as cli
from sed_tpu_torch.io import audio
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling, MobileNetV1
from sed_tpu_torch.models.convert import (cnn_avg_pooling_state_dict, m5_state_dict,
                                          mobilenet_state_dict)
from sed_tpu_torch.models.m5 import M5
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.utils import events_post

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(working_sample_rate=8000, time_margin=0.33)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_variables(flax_model, sample, seed=0):
    """flax init, then every scale, bias and BN statistic drawn from ``seed``."""
    variables = flax_model.init(jax.random.key(seed), sample, train=False)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(draw, variables["params"]),
            jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]))


def models_for(arch, seed=0):
    """(flax model, params, stats, the port's model) on the same weights."""
    if arch == "CnnAvgPooling":
        flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=TRAIN_CHANNEL_AND_POOL)
        sample, port, convert = (jnp.zeros((1, 30, 64, 1)),
                                 CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL),
                                 cnn_avg_pooling_state_dict)
    elif arch == "MobileNetV1":
        flax_model = FlaxMobileNetV1(classes_num=1)
        sample, port, convert = jnp.zeros((1, 30, 64, 1)), MobileNetV1(1), mobilenet_state_dict
    else:
        flax_model = FlaxM5(classes_num=1)
        sample, port, convert = jnp.zeros((1, 31680, 1)), M5(1), m5_state_dict
    params, stats = seeded_variables(flax_model, sample, seed)
    port.load_state_dict(convert(params, stats), strict=True)
    return flax_model, params, stats, port


def write_wav(path, samples, sr, seed):
    """Noise with tonal bursts, int16."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    x = 0.2 * rng.standard_normal(samples)
    burst = (np.sin(2 * np.pi * 0.05 * t) > 0.6) * np.sin(2 * np.pi * 0.29 * sr * t)
    x = np.clip(x + 0.5 * burst, -1, 1)
    wavfile.write(path, sr, (x * 32767).astype(np.int16))
    return str(path)


# 403 frames at 8 kHz (hop 2640): not a multiple of 8, so a ragged tail.
SPEC_SAMPLES = 402 * 2640 + 100


@pytest.mark.parametrize("arch,window,halo,with_stats", [
    ("CnnAvgPooling", 64, 32, False),
    ("CnnAvgPooling", 48, 40, True),
    ("MobileNetV1", 64, 88, False),
])
def test_predict_file_matches_sed_tpu(tmp_path, arch, window, halo, with_stats):
    path = write_wav(tmp_path / "long.wav", SPEC_SAMPLES, 8000, seed=1)
    flax_model, params, stats, port = models_for(arch, seed=2)
    mean = std = None
    if with_stats:
        rng = np.random.default_rng(3)
        mean = rng.uniform(-60, -40, 64).astype(np.float32)
        std = rng.uniform(5, 15, 64).astype(np.float32)
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    want_mel, want = jax_cli.predict_file(flax_model, state, path,
                                          jax_configs.SpectrogramConfig(**SMALL), mean, std,
                                          window=window, halo=halo)
    kernels.reset_launch_counts()
    log_mel, got = cli.predict_file(port, path, configs.SpectrogramConfig(**SMALL), mean, std,
                                    window=window, halo=halo, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (400, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert log_mel.shape == want_mel.shape == (1, 403, 64)
    np.testing.assert_allclose(log_mel.numpy(), want_mel, rtol=0, atol=1e-4)   # dB
    assert not any(kernels.LAUNCHES.values())   # the CPU runs the plain versions


def test_predict_file_equals_the_whole_recording_forward(tmp_path):
    path = write_wav(tmp_path / "long.wav", SPEC_SAMPLES, 8000, seed=4)
    _, _, _, port = models_for("MobileNetV1", seed=5)
    cfg = configs.SpectrogramConfig(**SMALL)
    log_mel, got = cli.predict_file(port, path, cfg, window=64, halo=64, device="cpu")
    with torch.inference_mode():
        whole = port(log_mel[None])[0].numpy()
    assert got.shape == whole.shape
    np.testing.assert_allclose(got, whole, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch,halo", [("CnnAvgPooling", 8), ("CnnAvgPooling", 32),
                                       ("MobileNetV1", 64), ("MobileNetV1", 96)])
def test_halo_floor_prints_sed_tpu_message(tmp_path, capsys, arch, halo):
    path = write_wav(tmp_path / "short.wav", 30 * 2640, 8000, seed=6)
    flax_model, params, stats, port = models_for(arch)
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    jax_cli.predict_file(flax_model, state, path, jax_configs.SpectrogramConfig(**SMALL),
                         window=64, halo=halo)
    want = capsys.readouterr().out
    cli.predict_file(port, path, configs.SpectrogramConfig(**SMALL), window=64, halo=halo,
                     device="cpu")
    got = capsys.readouterr().out
    assert got == want
    floor = {"CnnAvgPooling": 32, "MobileNetV1": 88}[arch]
    assert (f"using {floor}" in got) == (halo < floor)
    assert cli.halo_floor(port, halo) == max(halo, floor)


def test_halo_floor_refuses_a_model_without_a_windowed_path():
    with pytest.raises(ValueError, match="M5 has no windowed spectrogram path"):
        cli.halo_floor(M5(1), 64)


@pytest.mark.parametrize("arch", ["CnnAvgPooling", "M5"])
def test_timings_hold_each_stage_and_leave_the_scores(tmp_path, arch):
    _, _, _, port = models_for(arch, seed=9)
    timings = {}
    if arch == "M5":
        wcfg = configs.WaveformConfig(**SMALL)
        path = write_wav(tmp_path / "clip.wav", wcfg.frame_size + 40 * wcfg.hop_size, 8000,
                         seed=10)
        want = cli.predict_file_m5(port, path, wcfg, device="cpu")
        got = cli.predict_file_m5(port, path, wcfg, device="cpu", timings=timings)
    else:
        cfg = configs.SpectrogramConfig(**SMALL)
        path = write_wav(tmp_path / "clip.wav", 100 * 2640, 8000, seed=10)
        _, want = cli.predict_file(port, path, cfg, window=32, halo=32, device="cpu")
        _, got = cli.predict_file(port, path, cfg, window=32, halo=32, device="cpu",
                                  timings=timings)
    np.testing.assert_array_equal(got, want)
    assert sorted(timings) == ["featurizer", "model", "read"]
    assert all(t >= 0 for t in timings.values())


@pytest.mark.parametrize("frames", [41, 32, 1, 0])
def test_predict_file_m5_matches_sed_tpu(tmp_path, frames):
    wcfg = configs.WaveformConfig(**SMALL)
    samples = wcfg.frame_size + (frames - 1) * wcfg.hop_size + 77 if frames else 3000
    path = write_wav(tmp_path / "clip.wav", samples, 8000, seed=7)
    flax_model, params, stats, port = models_for("M5", seed=8)
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    want = jax_cli.predict_file_m5(flax_model, state, path,
                                   jax_configs.WaveformConfig(**SMALL))
    got = cli.predict_file_m5(port, path, wcfg, device="cpu")
    assert got.shape == want.shape == (frames, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def save_both(tmp_path, arch, seed):
    """The same seeded weights as a sed_tpu msgpack checkpoint and as the
    .pth that sed_tpu's exporter writes."""
    from sed_tpu.train.checkpoint import save_checkpoint
    from sed_tpu.train.optim import make_optimizer
    from sed_tpu.train.state import init_state
    from sed_tpu.train.torch_export import ARCH_EXPORTERS

    flax_model, params, stats, _ = models_for(arch, seed)
    sample = jnp.zeros((1, 31680, 1)) if arch == "M5" else jnp.zeros((1, 30, 64, 1))
    state = init_state(flax_model, jax.random.key(0), sample, make_optimizer(1e-6))
    state = state.replace(params=params, batch_stats=stats)
    ckpt = save_checkpoint(state, str(tmp_path / f"jax_{arch}"), 1)
    pth = tmp_path / f"{arch}.pth"
    torch.save({"iterations": 1, "model": ARCH_EXPORTERS[arch](params, stats),
                "optimizer": {}}, pth)
    return ckpt, str(pth)


def read_csv(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


def assert_csv_close(got_path, want_path, numeric_from):
    got_head, got = read_csv(got_path)
    want_head, want = read_csv(want_path)
    assert got_head == want_head and len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:numeric_from] == w[:numeric_from]
        np.testing.assert_allclose(np.array(g[numeric_from:], float),
                                   np.array(w[numeric_from:], float), rtol=0, atol=ATOL + 1e-6)


# Per arch: seconds of 48 kHz audio and the windowing flags.  Several
# windows and a ragged tail for the spectrogram archs (halo floors 32 / 88).
CLI_CASES = {
    "CnnAvgPooling": (40.3, ["--window", "16", "--halo", "16"]),
    "MobileNetV1": (76.9, ["--window", "32"]),
    "M5": (12.2, []),
}


@pytest.mark.parametrize("arch", list(CLI_CASES))
def test_cli_matches_sed_tpu_cli(tmp_path, arch):
    seconds, flags = CLI_CASES[arch]
    sr = 48000
    wavs = [write_wav(tmp_path / "long.wav", int(seconds * sr), sr, seed=9),
            write_wav(tmp_path / "short.wav", 5 * sr, sr, seed=10)]
    ckpt, pth = save_both(tmp_path, arch, seed=11)
    common = ["--arch", arch, "--device", "cpu", "--event_threshold", "0.5", *flags]
    jax_cli.main([*wavs, "--ckpt", ckpt, "--outputs_dir", str(tmp_path / "want"),
                  "--no_plot", *common])
    cli.main([*wavs, "--ckpt", pth, "--outputs_dir", str(tmp_path / "got"), *common])
    for wav in wavs:
        base = Path(wav).stem
        got = np.load(tmp_path / "got" / f"{base}_scores.npy")
        want = np.load(tmp_path / "want" / f"{base}_scores.npy")
        assert got.shape == want.shape and got.shape[0] > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert_csv_close(tmp_path / "got" / f"{base}_scores.csv",
                         tmp_path / "want" / f"{base}_scores.csv", numeric_from=2)
        assert_csv_close(tmp_path / "got" / f"{base}_events.csv",
                         tmp_path / "want" / f"{base}_events.csv", numeric_from=3)
        # The plot: the spectrogram archs draw one (matplotlib is here).
        assert (tmp_path / "got" / f"{base}.png").is_file() == (arch != "M5")


def test_cli_module_runs_the_windowed_path(tmp_path):
    sr = 48000
    wav = write_wav(tmp_path / "clip.wav", 25 * sr, sr, seed=12)
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL, generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, tmp_path / "model.pth")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "sed_tpu_torch.cli.infer", "--device", "cpu", "--no_plot",
         "--window", "16", "--halo", "32", "--ckpt", str(tmp_path / "model.pth"),
         "--outputs_dir", str(out), wav], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "receptive field" not in proc.stdout   # 32 is CnnAvgPooling's floor
    _, want = cli.predict_file(model, wav, configs.SpectrogramConfig(), window=16, halo=32,
                               device="cpu")
    # Another process, another thread count: float32 summation order only.
    np.testing.assert_allclose(np.load(out / "clip_scores.npy"), want, rtol=0, atol=ATOL)
    assert not (out / "clip.png").exists()


def test_plot_without_matplotlib_is_refused_before_scoring(monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--ckpt", str(tmp_path / "absent.pth"), "--outputs_dir",
                  str(tmp_path / "out"), "a.wav"])
    assert exc.value.code == 2
    assert "--no_plot" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_m5_cli_notes_the_options_it_ignores(tmp_path, capsys):
    wav = write_wav(tmp_path / "clip.wav", 3 * 48000, 48000, seed=13)
    torch.save(M5(1).state_dict(), tmp_path / "m5.pth")
    cli.main([wav, "--arch", "M5", "--ckpt", str(tmp_path / "m5.pth"), "--device", "cpu",
              "--window", "512", "--outputs_dir", str(tmp_path / "out")])
    assert ("note: --window have no effect on the M5 waveform path (no featurizer, "
            "frames scored whole)") in capsys.readouterr().out
    assert np.load(tmp_path / "out" / "clip_scores.npy").shape == (8, 1)


@pytest.mark.parametrize("samples", [1000, 16000])
def test_write_wav_matches_sed_tpu(tmp_path, samples):
    x = 1.3 * np.random.default_rng(samples).standard_normal((samples, 2))
    audio.write_wav(str(tmp_path / "got.wav"), x, 16000)
    jax_audio.write_wav(str(tmp_path / "want.wav"), x, 16000)
    assert (tmp_path / "got.wav").read_bytes() == (tmp_path / "want.wav").read_bytes()


@pytest.mark.parametrize("workers", [0, 4])
def test_read_multichannel_audio_batch_matches_sed_tpu(tmp_path, workers):
    paths = []
    for i, (sr, ch) in enumerate([(48000, 1), (44100, 2), (48000, 3), (16000, 1)]):
        x = 0.3 * np.random.default_rng(i).standard_normal((sr // 4, ch))
        path = str(tmp_path / f"f{i}.wav")
        audio.write_wav(path, x, sr)
        paths.append(path)
    cfg = configs.AudioConfig(audio_channels=2)
    got = audio.read_multichannel_audio_batch(paths, 48000, cfg, workers=workers)
    want = jax_audio.read_multichannel_audio_batch(
        paths, 48000, jax_configs.AudioConfig(audio_channels=2), workers=0)
    assert len(got) == len(want) == len(paths)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_event_dict_matches_sed_tpu():
    scores = np.random.default_rng(0).uniform(0, 1, (200, 2))
    evs = events_post.extract_events(scores, 3, threshold=0.7, min_duration=0.5,
                                     merge_gap=0.4)
    want_evs = jax_events_post.extract_events(scores, 3, threshold=0.7, min_duration=0.5,
                                              merge_gap=0.4)
    assert events_post.event_dict(evs, ("a", "b")) == \
        jax_events_post.event_dict(want_evs, ("a", "b"))


@pytest.mark.parametrize("num", [0, 999, 1000, 48000, 31680, 15840, 1.5e9, -2500, 12345678])
def test_human_format_matches_sed_tpu(num):
    assert configs.human_format(num) == jax_configs.human_format(num)


@pytest.mark.parametrize("kw", [{}, SMALL, dict(audio_channels=2, mel_bins=128)])
def test_cfg_descriptors_match_sed_tpu(kw):
    assert configs.SpectrogramConfig(**kw).cfg_descriptor == \
        jax_configs.SpectrogramConfig(**kw).cfg_descriptor
    wkw = {k: v for k, v in kw.items() if k != "mel_bins"}
    assert configs.WaveformConfig(**wkw).cfg_descriptor == \
        jax_configs.WaveformConfig(**wkw).cfg_descriptor
    assert configs.DEFAULT_WAVEFORM == configs.WaveformConfig()
