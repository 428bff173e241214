"""sed_tpu_torch featurizer against sed_tpu's, on the CPU.

The port's ``logmel_features_batch`` on CPU tensors (the plain versions of
K1 + K2) against ``sed_tpu``'s fused Pallas path (``use_pallas='full'``,
interpret mode, so its K1 + K2 kernel bodies run) and its XLA path, for
float32, int16 (PCM16) and uint8 (µ-law) input.  Tolerance: <= 1e-4 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.ops.featurizer import logmel_features_batch as jax_logmel_batch
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer
from sed_tpu_torch.ops.mulaw import mulaw_encode

SMALL = dict(working_sample_rate=8000, time_margin=0.33)
ATOL_DB = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clips(dtype: str, batch: int, seconds: float, sr: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.3 * rng.standard_normal((batch, n, 1))
    x[0, :, 0] += 0.4 * np.sin(2 * np.pi * 1000.0 * t)   # one tonal clip
    x = np.clip(x, -1, 1).astype(np.float32)
    if dtype == "int16":
        return (x * 32767).astype(np.int16)
    if dtype == "uint8":
        return mulaw_encode(x)
    return x


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_featurizer_matches_jax_full_and_xla_paths(dtype):
    x = _clips(dtype, batch=2, seconds=10, sr=8000)
    got = featurizer.logmel_features_batch(
        torch.from_numpy(x), SpectrogramConfig(**SMALL)).numpy()
    jcfg = JaxSpectrogramConfig(**SMALL)
    full = np.asarray(jax_logmel_batch(jnp.asarray(x), jcfg, use_pallas="full"))
    xla = np.asarray(jax_logmel_batch(jnp.asarray(x), jcfg, use_pallas=False))
    assert got.shape == full.shape == xla.shape == (2, 1, 31, 64)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, full, rtol=0, atol=ATOL_DB)
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL_DB)


def test_featurizer_production_config_matches_jax_xla_path():
    x = _clips("float32", batch=1, seconds=3, sr=48000, seed=3)
    got = featurizer.logmel_features_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_logmel_batch(jnp.asarray(x), JaxSpectrogramConfig(),
                                       use_pallas=False))
    assert got.shape == want.shape == (1, 1, 10, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DB)


def test_multichannel_and_single_clip_layouts():
    """Batch and channel layout; a different batch shape changes the CPU
    matmul/FFT blocking, so values agree to float32 rounding (1e-5 dB)."""
    cfg = SpectrogramConfig(**SMALL)
    x = np.random.default_rng(4).standard_normal((2, 9000, 3)).astype(np.float32)
    batch = featurizer.logmel_features_batch(torch.from_numpy(x), cfg)
    assert batch.shape == (2, 3, 1 + 9000 // cfg.hop_size, cfg.mel_bins)
    for b in range(2):
        one = featurizer.logmel_features(torch.from_numpy(x[b]), cfg)
        torch.testing.assert_close(one, batch[b], rtol=0, atol=1e-5)
        chan = featurizer.logmel_features(torch.from_numpy(x[b, :, 2:3]), cfg)
        torch.testing.assert_close(chan[0], batch[b, 2], rtol=0, atol=1e-5)


def test_power_to_logmel_is_k2_on_one_sided_power():
    cfg = SpectrogramConfig(**SMALL)
    power = torch.rand(2, 3, cfg.freq_bins, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(5))
    got = featurizer.power_to_logmel(power, cfg, use_pallas=True)
    assert got.shape == (2, 3, cfg.mel_bins) and got.dtype == torch.float32
    want = kernels.mel_log(power.reshape(6, -1).float(),
                           kernels.mel_bands(cfg, torch.device("cpu")))
    torch.testing.assert_close(got.reshape(6, -1), want, rtol=0, atol=0)


def test_cpu_tensors_never_launch_kernels():
    cfg = SpectrogramConfig(**SMALL)
    kernels.reset_launch_counts()
    x = torch.from_numpy(_clips("int16", batch=1, seconds=2, sr=8000))
    for use_pallas in ("auto", True, False):
        featurizer.logmel_features_batch(x, cfg, use_pallas=use_pallas)
    signals = featurizer.ingest_to_f32(x[..., 0])
    for impl in kernels.IMPL_KERNELS:
        if impl not in ("rollraw", "rolledge"):      # production config only
            kernels.logmel_waveform(signals, cfg, impl=impl)
    assert kernels.LAUNCHES == {"wave_stft_power": 0, "mel_log": 0,
                                "frames_stft_power": 0, "wave_stft_mel_log": 0,
                                "wave_packed_fft": 0, "wave_dft_power_bf16": 0,
                                "frames_dft_power_bf16": 0, "mel_log_bf16": 0,
                                "wave_stft_mel_log_mel_bf16": 0, "wave_stft_mel_log_bf16": 0,
                                "wave_packed_fft_bf16": 0, "fft_cross_pass": 0, "fft_subrows": 0,
                                "packed_power": 0, "tier_split": 0, "tier_inner": 0,
                                "tier_outer": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    cfg = SpectrogramConfig(**SMALL)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.wave_stft_power(torch.empty(1, 9000, device=meta),
                                torch.empty(cfg.nfft, device=meta),
                                cfg.hop_size, cfg.nfft)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mel_log(torch.empty(4, cfg.freq_bins, device=meta),
                        kernels.mel_bands(cfg, torch.device("cpu")))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.wave_packed_fft(torch.empty(1, 9000, device=meta),
                                torch.empty(cfg.nfft, device=meta),
                                cfg.hop_size, cfg.nfft)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.wave_stft_mel_log(torch.empty(1, 9000, device=meta),
                                  torch.empty(cfg.nfft, device=meta), cfg.hop_size,
                                  cfg.nfft, kernels.mel_bands(cfg, torch.device("cpu")))


@pytest.mark.parametrize("tier", ["fast", "turbo", "bf16x1", "bf16x3", "bf16x6"])
def test_reduced_precision_tiers_run_on_the_kernel_path(tier):
    """Each tier resolves to sed_tpu's precision value; the 'full' path runs
    it through K1t (here its plain version) then K2; the PyTorch-ops path
    ignores it, as sed_tpu's XLA path does."""
    from sed_tpu.ops.featurizer import resolve_featurizer_precision as jax_resolve

    precision = featurizer.resolve_featurizer_precision(tier)
    assert precision == jax_resolve(tier)
    cfg = SpectrogramConfig(**SMALL)
    x = torch.from_numpy(_clips("int16", batch=1, seconds=2, sr=8000))
    got = featurizer.logmel_features_batch(x, cfg, pallas_precision=precision)
    want = kernels.logmel_waveform(featurizer.ingest_to_f32(x[..., 0]), cfg,
                                   precision=precision)
    torch.testing.assert_close(got[:, 0], want, rtol=0, atol=0)
    assert not torch.equal(got, featurizer.logmel_features_batch(x, cfg))
    torch.testing.assert_close(
        featurizer.logmel_features_batch(x, cfg, use_pallas=False, pallas_precision=precision),
        featurizer.logmel_features_batch(x, cfg, use_pallas=False), rtol=0, atol=0)


def test_precision_resolution_and_ingest_rules():
    assert featurizer.resolve_featurizer_precision(None) is None
    assert featurizer.resolve_featurizer_precision("parity") is None
    with pytest.raises(ValueError):
        featurizer.resolve_featurizer_precision("bogus")
    pcm = torch.tensor([-32768, -1, 0, 16384, 32767], dtype=torch.int16)
    torch.testing.assert_close(featurizer.ingest_to_f32(pcm),
                               pcm.double().div(32768.0).float(), rtol=0, atol=0)
    with pytest.raises(TypeError):
        featurizer.ingest_to_f32(torch.zeros(4, dtype=torch.int32))
