"""n_fft 65536 and 131072 (96 and 192 kHz) on the CPU, held against sed_tpu.

On a CUDA tensor these sizes run the cluster Stockham FFT (K1, K3, K5, K6
over 2 or 4 CTAs a frame), K2 at 32,769 and 65,537 bins, the tier kernels
at n1 = 256 and the wgmma K6t; here, on CPU tensors, their plain versions
run, on seeded numpy input of one signal of two hops (3 frames), against
sed_tpu's Pallas kernels in interpret mode (each call takes seconds, so one
sed_tpu call a size and class):

  * ``logmel_waveform`` at 'roll', 'fuse' and 'pack': parity within 1e-4 dB
    of sed_tpu's parity log-mel; 'fast' within 1e-3 dB of sed_tpu's fast;
    'turbo' within 0.05 dB of sed_tpu's turbo (on the CPU sed_tpu's DEFAULT
    dot computes in float32, so its turbo is its parity: the turbo class of
    ``test_torch_featurizer_tiers.py``);
  * ``make_batch_predictor`` (``logmel_features_batch``, then CnnAvgPooling
    with seeded weights) against sed_tpu's at parity, within 1e-5;
  * the tick's ``logmel_frames`` against ``logmel_frames_pallas``, within
    1e-4 dB;
  * ``cuda_featurizer.launch_plan``, what each kernel launches at an n_fft:
    every plan within the 227 KB a block can use (its refusal above the
    largest n_fft, 2^20, is held in ``test_torch_nfft_range.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.inference import make_batch_predictor as jax_make_batch_predictor
from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
from sed_tpu.ops import pallas_featurizer as jax_pallas
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import make_batch_predictor
from sed_tpu_torch.models.cnn import CnnAvgPooling
from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer

RATES = (96000, 192000)
PARITY_DB, FAST_DB, TURBO_DB = 1e-4, 1e-3, 0.05
NARROW = ((8, 2), (16, 1))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(sr):
    return SpectrogramConfig(working_sample_rate=sr), JaxSpectrogramConfig(working_sample_rate=sr)


def signal(sr, hops=2, seed=0) -> np.ndarray:
    """(1, hops * hop) f32: noise and a 1 kHz tone."""
    cfg = configs(sr)[0]
    n = hops * cfg.hop_size
    rng = np.random.default_rng(seed + sr)
    x = 0.3 * rng.standard_normal(n) + 0.4 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / sr)
    return x[None].astype(np.float32)


@pytest.fixture(scope="module")
def sed_tpu_logmel():
    """sed_tpu's log-mel of ``signal(sr)`` at a precision ('fuse', interpret
    mode), each computed once.  On the CPU sed_tpu's turbo is its parity
    (its DEFAULT dot computes in float32), so turbo is held against it."""
    cache = {}

    def get(sr, precision):
        key = (sr, None if precision == "bf16x1" else precision)
        if key not in cache:
            jcfg = configs(sr)[1]
            cache[key] = np.asarray(jax_pallas.logmel_waveform_pallas(
                jnp.asarray(signal(sr)), jcfg, impl="fuse", precision=key[1]))
        return cache[key]

    return get


@pytest.mark.parametrize("precision, atol", [(None, PARITY_DB), ("bf16x3", FAST_DB),
                                             ("bf16x1", TURBO_DB)], ids=str)
@pytest.mark.parametrize("sr", RATES)
def test_impls_match_sed_tpu(sr, precision, atol, sed_tpu_logmel):
    """'roll', 'fuse' and 'pack' at parity (1e-4 dB), fast (1e-3 dB) and
    turbo (0.05 dB) against sed_tpu's log-mel of the same signal."""
    cfg = configs(sr)[0]
    want = sed_tpu_logmel(sr, precision)
    assert want.shape == (1, 3, cfg.mel_bins)
    for impl in ("roll", "fuse", "pack"):
        got = kernels.logmel_waveform(torch.from_numpy(signal(sr)), cfg, impl=impl,
                                      precision=precision).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=impl)


@pytest.mark.parametrize("sr", RATES)
def test_batch_predictor_matches_sed_tpu(sr):
    """logmel_features_batch, then a CnnAvgPooling with the same seeded
    weights, on an int16 clip of 6 hops (7 frames): scores within 1e-5."""
    cfg, jcfg = configs(sr)
    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=NARROW)
    variables = flax_model.init(jax.random.key(0), jnp.zeros((1, 7, 64, 1)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(1, NARROW)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    x = (np.clip(signal(sr, hops=6, seed=1)[..., None], -1, 1) * 32767).astype(np.int16)
    want = np.asarray(jax_make_batch_predictor(flax_model, jcfg)(params, stats, jnp.asarray(x)))
    got = make_batch_predictor(port, cfg, device="cpu")(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sr", RATES)
def test_tick_logmel_frames_match_sed_tpu(sr):
    """The tick's featurizer (K3 then K2) on int16 rows of n_fft samples."""
    cfg, jcfg = configs(sr)
    x = signal(sr, hops=3, seed=2)[0]
    rows = np.stack([x[i * cfg.hop_size // 4:][: cfg.nfft] for i in range(3)])
    rows = (np.clip(rows, -1, 1) * 32767).astype(np.int16)
    want = np.asarray(jax_pallas.logmel_frames_pallas(jnp.asarray(rows), jcfg))
    got = featurizer.logmel_frames(torch.from_numpy(rows), cfg).numpy()
    assert got.shape == want.shape == (3, cfg.mel_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_DB)


@pytest.mark.parametrize("sr", (8000, 48000) + RATES)
def test_launch_plan_admits_each_rate_within_shared_memory(sr):
    """Every kernel's plan at the rate's n_fft: the FFT kernels over one CTA
    up to n_fft 32768, a cluster of 2 at 65536 and 4 at 131072; K1t's and
    K5t's route and cluster the library's (sed_tier_fused_plan: None
    without a card; test_torch_cuda.py reads K5t's n2 / 64 CTAs on the
    card); every plan's dynamic shared memory within 232,448 B."""
    cfg = configs(sr)[0]
    plan = kernels.launch_plan(cfg.nfft, kernels.mel_bands(cfg, torch.device("cpu")).n_segments)
    want_cluster = max(1, cfg.nfft // 32768)
    for name in ("wave_stft_power", "frames_stft_power", "wave_stft_mel_log",
                 "wave_packed_fft"):
        assert plan[name]["cluster"] == want_cluster
    log2_n = cfg.nfft.bit_length() - 1
    n2 = cfg.nfft >> (log2_n // 2)
    if log2_n in kernels.TIER_LOG2_N:
        assert n2 // 64 <= 8
        for name in ("wave_stft_mel_log_bf16", "wave_dft_power_bf16"):
            assert plan[name]["route"] is None and plan[name]["cluster"] is None
    if log2_n in kernels.PACKED_TIER_LOG2_N:
        assert plan["wave_packed_fft_bf16"]["cluster"] == 1
    # K2's entry (None here) is the library's: tests/test_torch_cuda.py reads
    # it on the card.
    assert all(p["smem"] <= 232448 for p in plan.values() if p["smem"] is not None)
