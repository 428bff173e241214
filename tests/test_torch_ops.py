"""sed_tpu_torch featurizer ops against sed_tpu, on the CPU.

The port's plain versions of the two CUDA kernels (K1 STFT power, K2
mel-log) are held against the JAX package's Pallas kernels run in interpret
mode, on the same numpy inputs.  Tolerances:
  * filterbank and window: bit-exact (same float64 math, same cast);
  * K1: abs error <= 1e-5 x the frame's peak power;
  * K2: <= 1e-4 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.ops import mel as jax_mel
from sed_tpu.ops import stft as jax_stft
from sed_tpu.ops.mulaw import mulaw_decode as jax_mulaw_decode
from sed_tpu.ops.mulaw import mulaw_encode as jax_mulaw_encode
from sed_tpu.ops.pallas_featurizer import (power_to_logmel_pallas,
                                           stft_power_from_waveform_pallas)
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import mel, mulaw, stft

SMALL = dict(working_sample_rate=8000, time_margin=0.33)  # n_fft 8192, hop 2640
CONFIGS = [pytest.param(SMALL, id="small"), pytest.param({}, id="production")]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_derived_properties_match(kw):
    port, ref = SpectrogramConfig(**kw), JaxSpectrogramConfig(**kw)
    for name in ("frame_size", "hop_size", "frames_per_second", "classes_num",
                 "nfft", "mel_max_freq", "freq_bins", "train_crop_size"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("kw", CONFIGS)
def test_filterbank_and_window_bit_exact(kw):
    port, ref = SpectrogramConfig(**kw), JaxSpectrogramConfig(**kw)
    for dtype in (np.float64, np.float32):
        got = mel.mel_filterbank(port, dtype=dtype)
        want = jax_mel.mel_filterbank(ref, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = stft.padded_window(port.frame_size, port.nfft)
    want = jax_stft.padded_window(ref.frame_size, ref.nfft)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,pad", [(10, 3), (10, 9), (5, 12), (2, 7), (1, 4)])
def test_reflect_indices_match_numpy_reflect_pad(n, pad):
    y = np.arange(n) * 10
    want = np.pad(y, pad, mode="reflect")
    np.testing.assert_array_equal(y[stft.reflect_indices(n, pad).numpy()], want)


@pytest.mark.parametrize("samples", [8000, 8000 * 3 + 17])
def test_stft_matches_jax_stft(samples):
    """The plain STFT (torch.fft.rfft) against sed_tpu's XLA-FFT stft, on
    the same signal: complex bins to 1e-5 x the frame's peak magnitude."""
    cfg, jcfg = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
    y = np.random.default_rng(samples).standard_normal(samples).astype(np.float32)
    want = np.asarray(jax_stft.stft(jnp.asarray(y), jcfg, fft_impl="fft"))
    got = stft.stft(torch.from_numpy(y), cfg).numpy()
    re, im = stft.stft_realimag(torch.from_numpy(y), cfg)
    assert got.shape == want.shape == (1 + samples // cfg.hop_size, cfg.freq_bins)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak)
    np.testing.assert_array_equal(re.numpy() + 1j * im.numpy(), got)
    assert stft.num_frames(samples, cfg.hop_size) == got.shape[0]


def test_mel_bands_equal_dense_filterbank():
    """K2's band description holds every non-zero of the f32 filterbank."""
    for cfg in (SpectrogramConfig(**SMALL), SpectrogramConfig()):
        fb = mel.mel_filterbank(cfg, dtype=np.float32)
        lo, hi, off, w = kernels.mel_bands_numpy(fb)
        rebuilt = np.zeros_like(fb)
        for b in range(fb.shape[1]):
            rebuilt[lo[b]:hi[b], b] = w[off[b]:off[b] + hi[b] - lo[b]]
        np.testing.assert_array_equal(rebuilt, fb)
    # Production: 31,676 non-zeros, each band 85..1,982 contiguous bins.
    assert w.size == np.count_nonzero(fb) == 31676
    assert (hi - lo).min() == 85 and (hi - lo).max() == 1982


def _jax_k1_natural(sigs: np.ndarray, cfg) -> np.ndarray:
    """JAX K1 (impl='roll', interpret mode) mapped to one-sided natural order:
    the flat index k2*n1 + k1 holds bin n2*k1 + k2."""
    flat = np.asarray(stft_power_from_waveform_pallas(
        jnp.asarray(sigs), cfg, interpret=True, impl="roll"))
    n1, n2, *_ = jax_stft._matmul_fft_constants(cfg.nfft)
    lead = flat.shape[:-1]
    natural = flat.reshape(*lead, n2, n1).swapaxes(-1, -2).reshape(*lead, cfg.nfft)
    return natural[..., : cfg.nfft // 2 + 1]


@pytest.mark.parametrize("samples", [20 * 8000, 20 * 8000 + 1317])
def test_k1_plain_matches_jax_kernel(samples):
    cfg = SpectrogramConfig(**SMALL)
    rng = np.random.default_rng(samples)
    t = np.arange(samples) / cfg.working_sample_rate
    sigs = np.stack([
        0.3 * rng.standard_normal(samples),
        0.5 * np.sin(2 * np.pi * 440.0 * t) + 1e-3 * rng.standard_normal(samples),
    ]).astype(np.float32)
    want = _jax_k1_natural(sigs, JaxSpectrogramConfig(**SMALL))
    got = kernels.wave_stft_power(
        torch.from_numpy(sigs), kernels.stft_window(cfg, CPU), cfg.hop_size,
        cfg.nfft).numpy()
    assert got.shape == want.shape == (2, 1 + samples // cfg.hop_size, cfg.freq_bins)
    peak = want.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak)


@pytest.mark.parametrize("kw", CONFIGS)
def test_k2_plain_matches_jax_kernel(kw):
    cfg = SpectrogramConfig(**kw)
    rng = np.random.default_rng(1)
    power = (rng.random((19, cfg.freq_bins)) ** 4 * 1e3).astype(np.float32)
    power[3] = 0.0                                   # amin floor: -100 dB
    power[5, : cfg.freq_bins // 2] *= 1e-9           # wide dynamic range
    want = np.asarray(power_to_logmel_pallas(
        jnp.asarray(power), JaxSpectrogramConfig(**kw), interpret=True))
    got = kernels.mel_log(torch.from_numpy(power),
                          kernels.mel_bands(cfg, CPU)).numpy()
    assert got.shape == want.shape == (19, cfg.mel_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3], -100.0)


def test_mulaw_codec_matches_jax():
    rng = np.random.default_rng(2)
    x = np.clip(0.4 * rng.standard_normal(4096), -1, 1).astype(np.float32)
    x[:7] = [0.0, 1.0, -1.0, 1e-6, -1e-6, 0.5, -0.5]
    u8 = mulaw.mulaw_encode(x)
    np.testing.assert_array_equal(u8, jax_mulaw_encode(x))
    pcm = (x * 32767).astype(np.int16)
    np.testing.assert_array_equal(mulaw.mulaw_encode(pcm), jax_mulaw_encode(pcm))
    all_codes = np.arange(256, dtype=np.uint8)
    got = mulaw.mulaw_decode(torch.from_numpy(all_codes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mulaw_decode(all_codes)),
                               rtol=2e-7, atol=0)
    assert got[0] == 0.0 and got.dtype == np.float32
    with pytest.raises(TypeError):
        mulaw.mulaw_decode(torch.zeros(3, dtype=torch.int16))


def test_power_to_db_matches_librosa_formula():
    p = torch.tensor([0.0, 1e-12, 1e-10, 1.0, 123.0], dtype=torch.float64)
    want = 10 * np.log10(np.maximum(1e-10, p.numpy()))
    np.testing.assert_allclose(mel.power_to_db(p).numpy(), want, rtol=1e-15)
