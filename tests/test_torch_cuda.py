"""The CUDA kernels of sed_tpu_torch on the card (marker ``gpu``).

These tests need a CUDA device and ``nvcc``; without a card they skip.  They
import neither JAX nor sed_tpu, so they also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances (against the plain versions computed in float64 on the card):
  * K1 power: abs error <= 1e-5 x the frame's peak power;
  * K2 and the whole featurizer: <= 1e-4 dB;
  * scores, CUDA against CPU: <= 1e-4 abs (another summation order).
"""

import numpy as np
import pytest
import torch

from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import batch_predict_files, make_batch_predictor
from sed_tpu_torch.models.cnn import TRAIN_CHANNEL_AND_POOL, CnnAvgPooling
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer
from sed_tpu_torch.ops import mel as mel_ops
from sed_tpu_torch.ops.mulaw import mulaw_encode

pytestmark = pytest.mark.gpu

SMALL = SpectrogramConfig(working_sample_rate=8000, time_margin=0.33)
PROD = SpectrogramConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def signals(n_sig, n, sr, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, device=device) / sr
    noise = 0.3 * torch.randn(n_sig, n, generator=g, device=device)
    freqs = torch.linspace(100.0, sr / 3, n_sig, device=device)[:, None]
    return (noise + 0.5 * torch.sin(2 * np.pi * freqs * t)).float().contiguous()


@pytest.mark.parametrize("cfg,n", [
    (SMALL, 20 * 8000), (SMALL, 20 * 8000 + 1317), (SMALL, 3000), (SMALL, 7),
    (PROD, 3 * 48000 + 11),
])
def test_k1_matches_float64_plain(cuda, cfg, n):
    waves = signals(3, n, cfg.working_sample_rate, cuda)
    window = kernels.stft_window(cfg, cuda)
    before = kernels.LAUNCHES["wave_stft_power"]
    got = kernels.wave_stft_power(waves, window, cfg.hop_size, cfg.nfft)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wave_stft_power"] == before + 1
    want = kernels.wave_stft_power_plain(waves.double(), window, cfg.hop_size, cfg.nfft)
    assert got.shape == want.shape == (3, 1 + n // cfg.hop_size, cfg.freq_bins)
    peak = want.amax(dim=-1, keepdim=True)
    assert bool(((got.double() - want).abs() <= 1e-5 * peak).all())


@pytest.mark.parametrize("cfg", [SMALL, PROD])
def test_k2_matches_float64_plain(cuda, cfg):
    g = torch.Generator(device=cuda).manual_seed(1)
    power = torch.rand(37, cfg.freq_bins, generator=g, device=cuda) ** 4 * 1e3
    power[3] = 0.0
    power[5, : cfg.freq_bins // 2] *= 1e-9
    bands = kernels.mel_bands(cfg, cuda)
    before = kernels.LAUNCHES["mel_log"]
    got = kernels.mel_log(power, bands)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mel_log"] == before + 1
    fb64 = torch.from_numpy(mel_ops.mel_filterbank(cfg, np.float64)).to(cuda)
    want = kernels.mel_log_plain(power.double(), fb64)
    assert float((got.double() - want).abs().max()) <= 1e-4
    assert bool((got[3] == -100.0).all())


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_featurizer_cuda_matches_cpu(cuda, dtype):
    x = signals(2, 10 * 8000, 8000, cuda, seed=2).clamp(-1, 1).cpu().numpy()
    if dtype == "int16":
        x = (x * 32767).astype(np.int16)
    elif dtype == "uint8":
        x = mulaw_encode(x)
    x = torch.from_numpy(x)[..., None]
    got = featurizer.logmel_features_batch(x.to(cuda), SMALL).cpu()
    want = featurizer.logmel_features_batch(x, SMALL)
    assert got.shape == want.shape == (2, 1, 31, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    window = kernels.stft_window(SMALL, cuda)
    waves = signals(2, 9000, 8000, cuda)
    with pytest.raises(TypeError):
        kernels.wave_stft_power(waves.double(), window, SMALL.hop_size, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_power(waves.t(), window, SMALL.hop_size, SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_power(waves, window[:-1].contiguous(), SMALL.hop_size,
                                SMALL.nfft)
    with pytest.raises(ValueError):
        kernels.wave_stft_power(waves, window.cpu(), SMALL.hop_size, SMALL.nfft)
    big = torch.zeros(65536, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        kernels.wave_stft_power(waves, big, 1000, 65536)
    bands = kernels.mel_bands(SMALL, cuda)
    with pytest.raises(ValueError):
        kernels.mel_log(torch.zeros(4, SMALL.freq_bins - 1, device=cuda), bands)
    with pytest.raises(TypeError):
        kernels.mel_log(torch.zeros(4, SMALL.freq_bins, device=cuda,
                                    dtype=torch.float16), bands)


def test_predictor_and_files_cuda_match_cpu(cuda, tmp_path):
    from scipy.io import wavfile

    model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL,
                          generator=torch.Generator().manual_seed(0))
    cpu_model = CnnAvgPooling(1, TRAIN_CHANNEL_AND_POOL)
    cpu_model.load_state_dict(model.state_dict())
    x = (signals(3, 5 * 48000, 48000, cuda, seed=3).clamp(-1, 1) * 32767)
    x = x.to(torch.int16)[..., None]
    kernels.reset_launch_counts()
    got = make_batch_predictor(model, PROD, device=cuda)(x).cpu()
    assert kernels.LAUNCHES == {"wave_stft_power": 1, "mel_log": 1}
    want = make_batch_predictor(cpu_model, PROD, device="cpu")(x.cpu())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    paths = []
    for i, n in enumerate([5 * 48000, 4 * 48000, 5 * 48000]):
        path = tmp_path / f"c{i}.wav"
        wavfile.write(path, 48000, x[i % 3, :n, 0].cpu().numpy())
        paths.append(str(path))
    on_card = batch_predict_files(model, paths, PROD, device=cuda)
    on_cpu = batch_predict_files(cpu_model, paths, PROD, device="cpu")
    for p in paths:
        np.testing.assert_allclose(on_card[p], on_cpu[p], rtol=0, atol=1e-4)
