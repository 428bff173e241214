"""The slice end to end on the CPU: sed_tpu_torch scoring against sed_tpu.

JAX side: ``logmel_features_batch(use_pallas='full')`` (interpret mode) ->
flax CnnAvgPooling -> sigmoid, i.e. bench.py's ``pipeline_fn``.  Port side:
``make_batch_predictor(..., device='cpu')`` on the converted weights.
Scores must agree to <= 1e-5 abs.  Also ``batch_predict_files`` on WAV files,
the ``python -m sed_tpu_torch.cli.infer --batch`` entry point, and the CLI's
options: those still refused by name and those ported since.
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

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.inference import batch_predict_files as jax_batch_predict_files
from sed_tpu.inference import make_batch_predictor as jax_make_batch_predictor
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.ops.featurizer import logmel_features_batch as jax_logmel_batch
from sed_tpu_torch.cli import infer as cli
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import batch_predict_files, make_batch_predictor
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.ops import cuda_featurizer as kernels

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(working_sample_rate=8000, time_margin=0.33)
NARROW = ((8, 2), (16, 1))
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_and_port_models(model_config, frames, mel_bins=64, classes=1):
    flax_model = FlaxCnnAvgPooling(classes_num=classes, model_config=model_config)
    variables = flax_model.init(jax.random.key(0),
                                jnp.zeros((1, frames, mel_bins, 1)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(classes, model_config)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    return flax_model, params, stats, port


def clips(batch, seconds, sr, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((batch, int(seconds * sr), 1))
    return np.clip(x, -1, 1).astype(np.float32)


def test_slice_scores_match_jax_pipeline():
    x = (clips(2, 10, 8000) * 32767).astype(np.int16)
    jcfg = JaxSpectrogramConfig(**SMALL)
    flax_model, params, stats, port = flax_and_port_models(NARROW, 31)

    feats = jax_logmel_batch(jnp.asarray(x), jcfg, use_pallas="full")
    logits = flax_model.apply({"params": params, "batch_stats": stats},
                              jnp.transpose(feats, (0, 2, 3, 1)), train=False)
    want = np.asarray(jax.nn.sigmoid(logits))

    kernels.reset_launch_counts()
    predict = make_batch_predictor(port, SpectrogramConfig(**SMALL), device="cpu")
    got = predict(x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (2, 30, 1)   # 31 frames -> 15 -> x2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert kernels.LAUNCHES == {"wave_stft_power": 0, "mel_log": 0,
                                "frames_stft_power": 0, "wave_stft_mel_log": 0,
                                "wave_packed_fft": 0, "wave_dft_power_bf16": 0,
                                "frames_dft_power_bf16": 0, "mel_log_bf16": 0,
                                "wave_stft_mel_log_mel_bf16": 0, "wave_stft_mel_log_bf16": 0,
                                "wave_packed_fft_bf16": 0, "fft_cross_pass": 0, "fft_subrows": 0,
                                "packed_power": 0, "tier_split": 0, "tier_inner": 0,
                                "tier_outer": 0}


def test_mean_std_normalization_matches_jax_predictor():
    x = clips(2, 6, 8000, seed=1)
    jcfg = JaxSpectrogramConfig(**SMALL)
    flax_model, params, stats, port = flax_and_port_models(NARROW, 19)
    rng = np.random.default_rng(2)
    mean = rng.uniform(-60, -40, 64).astype(np.float32)
    std = rng.uniform(5, 15, 64).astype(np.float32)
    want = np.asarray(jax_make_batch_predictor(flax_model, jcfg, mean=mean, std=std)(
        params, stats, jnp.asarray(x)))
    got = make_batch_predictor(port, SpectrogramConfig(**SMALL), mean=mean, std=std,
                               device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def write_wavs(directory: Path, lengths, sr, seed=0):
    paths = []
    for i, n in enumerate(lengths):
        pcm = (clips(1, n / sr, sr, seed + i)[0, :, 0] * 32767).astype(np.int16)
        path = directory / f"clip{i}.wav"
        wavfile.write(path, sr, pcm)
        paths.append(str(path))
    return paths


def test_batch_predict_files_matches_jax(tmp_path):
    paths = write_wavs(tmp_path, [24000, 40000, 24000], 8000)
    jcfg = JaxSpectrogramConfig(**SMALL)
    flax_model, params, stats, port = flax_and_port_models(NARROW, 10)
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    want = jax_batch_predict_files(flax_model, state, paths, jcfg)
    got = batch_predict_files(port, paths, SpectrogramConfig(**SMALL), device="cpu")
    assert set(got) == set(want) == set(paths)
    for p in paths:
        assert got[p].shape == want[p].shape
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=ATOL)


def test_cli_batch_writes_scores_and_events(tmp_path):
    sr = 48000
    paths = write_wavs(tmp_path, [3 * sr, 4 * sr], sr, seed=5)
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    torch.save({"iterations": 7, "model": model.state_dict(), "optimizer": {}},
               tmp_path / "model.pth")
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "sed_tpu_torch.cli.infer", "--batch", "--device", "cpu",
         "--ckpt", str(tmp_path / "model.pth"), "--outputs_dir", str(out),
         "--event_threshold", "0.5", *paths],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    predict = make_batch_predictor(cli.load_model(str(tmp_path / "model.pth"), 1),
                                   SpectrogramConfig(), device="cpu")
    from sed_tpu_torch.io.audio import read_multichannel_audio

    for p in paths:
        base = Path(p).stem
        scores = np.load(out / f"{base}_scores.npy")
        wav = read_multichannel_audio(p, target_fs=sr).astype(np.float32)
        want = predict(wav[None]).numpy()[0]
        assert scores.shape == want.shape
        np.testing.assert_allclose(scores, want, rtol=0, atol=ATOL)
        lines = (out / f"{base}_scores.csv").read_text().splitlines()
        assert lines[0] == "frame,time_sec,doorslam"
        assert len(lines) == 1 + len(scores)
        assert (out / f"{base}_events.csv").read_text().startswith(
            "class,start_sec,end_sec,peak")


def test_bare_state_dict_checkpoint_loads(tmp_path):
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), tmp_path / "bare.pth")
    loaded = cli.load_model(str(tmp_path / "bare.pth"), 1)
    for key, value in model.state_dict().items():
        assert torch.equal(value, loaded.state_dict()[key]), key


@pytest.mark.parametrize("flags", [
    ["--num_devices", "2"],
])
def test_cli_refuses_unported_options(flags, capsys):
    """``--num_devices`` is ported for ``--batch``
    (tests/test_torch_parallel_cli.py) and refused without it with sed_tpu's
    usage error; the fast/turbo tiers, once refused here, are ported
    (test_cli_options_once_refused_as_unported)."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--ckpt", "unused.pth", *flags, "a.wav"])
    assert exc.value.code == 2
    assert "--num_devices shards the batched path; add --batch" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    [],                                  # no --batch: the windowed path
    ["--batch", "--window", "512"],      # accepted; --batch does not window
    ["--batch", "--arch", "M5"],         # refused with sed_tpu's message
    ["--batch", "--quantize", "int8"],   # sed_tpu's note; --batch scores in float
    ["--batch", "--bf16"],               # the bf16 tier: within its band of float32
    # The featurizer tiers (K1t's plain version here): equal to the batch
    # predictor at the same tier, per file and batched.
    ["--batch", "--featurizer_precision", "turbo"],
    ["--batch", "--featurizer_precision", "fast"],
    ["--featurizer_precision", "turbo"],
])
def test_cli_options_once_refused_as_unported(flags, tmp_path, capsys):
    sr = 48000
    paths = write_wavs(tmp_path, [4 * sr], sr, seed=6)
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(1))
    torch.save({"model": model.state_dict()}, tmp_path / "model.pth")
    out = tmp_path / "out"
    argv = ["--ckpt", str(tmp_path / "model.pth"), "--device", "cpu", "--no_plot",
            "--outputs_dir", str(out), *flags, *paths]
    if "M5" in flags:
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        assert ("--batch applies to the spectrogram archs; the M5 path already "
                "scores all frames of a file batched") in capsys.readouterr().err
        return
    cli.main(argv)
    captured = capsys.readouterr()
    assert "not ported" not in captured.err
    if "--quantize" in flags:
        assert ("--quantize applies to the per-file windowed path; --batch uses the "
                "float forward") in captured.out
    from sed_tpu_torch.io.audio import read_multichannel_audio

    wav = read_multichannel_audio(paths[0], target_fs=sr).astype(np.float32)
    tier = flags[flags.index("--featurizer_precision") + 1] \
        if "--featurizer_precision" in flags else None
    want = make_batch_predictor(model, SpectrogramConfig(), featurizer_precision=tier,
                                device="cpu")(wav[None])[0]
    got = np.load(out / "clip0_scores.npy")
    assert got.shape == tuple(want.shape)
    # sed_tpu's band for the bf16 tier on scores (tests/test_stream_pool.py:737).
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=0.05 if "--bf16" in flags else ATOL)


def test_cuda_device_is_never_silently_replaced():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    model = CnnAvgPooling(1, NARROW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch_predictor(model, SpectrogramConfig(**SMALL))
