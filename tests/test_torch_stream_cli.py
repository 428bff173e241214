"""``python -m sed_tpu_torch.cli.stream`` on the CPU, at the production
configuration (48 kHz, n_fft 32768, CnnAvgPooling(TRAIN_CHANNEL_AND_POOL)).

Every file's streamed scores equal the port's batch path on the same audio
(``make_batch_predictor``, itself held against ``sed_tpu`` in
tests/test_torch_slice.py): identical frame counts, scores within 1e-5.
"""

import json
import pickle

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sed_tpu_torch.cli import stream as cli
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import make_batch_predictor
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling

CFG = SpectrogramConfig()
SR = CFG.working_sample_rate
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ckpt(tmp_path):
    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    path = tmp_path / "model.pth"
    torch.save({"model": model.state_dict()}, path)
    return model, path


def write_wav(path, n, seed):
    y = (3000 * np.random.default_rng(seed).standard_normal(n)).astype(np.int16)
    wavfile.write(path, SR, y)
    return y


def test_stream_cli_matches_batch_scoring(ckpt, tmp_path, capsys):
    """Three files on two slots, the third joining when a slot frees, with
    normalization statistics and event extraction."""
    model, path = ckpt
    lengths = (3 * SR + 1234, 5 * SR, 4 * SR + 777)
    wavs = [tmp_path / f"clip{i}.wav" for i in range(3)]
    audio = [write_wav(w, n, i) for i, (w, n) in enumerate(zip(wavs, lengths))]
    rng = np.random.default_rng(9)
    mean = rng.uniform(-60, -40, 64).astype(np.float32)
    std = rng.uniform(5, 15, 64).astype(np.float32)
    with open(tmp_path / "mean_std.pkl", "wb") as f:
        pickle.dump({"mean": mean, "std": std}, f)
    out = tmp_path / "out"
    cli.main([*map(str, wavs), "--ckpt", str(path), "--device", "cpu",
              "--outputs_dir", str(out), "--slots", "2", "--stagger_ticks", "1",
              "--mean_std_file", str(tmp_path / "mean_std.pkl"),
              "--event_threshold", "0.5"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["files"] == 3 and summary["device"] == "cpu"
    assert sum(summary["kernel_launches"].values()) == 0    # CPU: plain versions
    predict = make_batch_predictor(model, CFG, mean=mean, std=std, device="cpu")
    for w, y in zip(wavs, audio):
        got = np.load(out / f"{w.stem}_scores.npy")
        want = predict(y[None, :, None]).numpy()[0]
        assert got.shape == want.shape, w.stem
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=w.stem)
        assert (out / f"{w.stem}_events.csv").is_file()


def test_stream_cli_short_file_does_not_abort_run(ckpt, tmp_path):
    """A clip shorter than nfft/2 samples cannot be featurized: it gets empty
    scores and the other file is still scored."""
    _, path = ckpt
    write_wav(tmp_path / "long.wav", 3 * SR, 0)
    write_wav(tmp_path / "short.wav", 2000, 1)
    out = tmp_path / "out"
    cli.main([str(tmp_path / "long.wav"), str(tmp_path / "short.wav"), "--ckpt",
              str(path), "--device", "cpu", "--outputs_dir", str(out)])
    assert np.load(out / "long_scores.npy").shape[0] > 0
    assert np.load(out / "short_scores.npy").shape == (0, 1)


@pytest.mark.parametrize("flags", [
    ["--quantize", "int8"], ["--bf16"], ["--num_devices", "2"],
    ["--featurizer_precision", "fast"],
])
def test_stream_cli_refuses_unported_options(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["a.wav", "--ckpt", "unused.pth", *flags])
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().err


def test_stream_cli_refuses_num_devices_for_m5_as_sed_tpu_does(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["a.wav", "--ckpt", "unused.pth", "--arch", "M5", "--num_devices", "2"])
    assert exc.value.code == 2
    assert "--num_devices applies to the spectrogram pool" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--arch", "M5"], ["--arch", "MobileNetV1"], ["--m5_pool", "device"],
    ["--featurizer", "xla"],
])
def test_stream_cli_options_once_refused_as_unported(flags, tmp_path, capsys):
    """Each option this CLI once refused now scores a file as offline
    scoring of its arch does: M5's hop-strided frames (``predict_file_m5``),
    MobileNetV1 through its logits view with its halo floor, ``--m5_pool``
    (no effect on CnnAvgPooling) and the xla tick featurizer."""
    from sed_tpu_torch.cli.infer import build_model, predict_file_m5
    from sed_tpu_torch.configs import WaveformConfig

    arch = flags[1] if flags[0] == "--arch" else "CnnAvgPooling"
    model = build_model(arch, 1)
    model.reset_parameters(torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict()}, tmp_path / "model.pth")
    y = write_wav(tmp_path / "clip.wav", 4 * SR + 321, 5)
    out = tmp_path / "out"
    cli.main([str(tmp_path / "clip.wav"), "--ckpt", str(tmp_path / "model.pth"),
              "--device", "cpu", "--outputs_dir", str(out), *flags])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["files"] == 1 and sum(summary["kernel_launches"].values()) == 0
    got = np.load(out / "clip_scores.npy")
    if arch == "M5":
        want = predict_file_m5(model, str(tmp_path / "clip.wav"), WaveformConfig(),
                               device="cpu")
    else:
        want = make_batch_predictor(model, CFG, device="cpu")(y[None, :, None]).numpy()[0]
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
