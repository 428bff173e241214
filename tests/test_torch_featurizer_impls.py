"""Every featurizer implementation of sed_tpu against its port, on the CPU.

``sed_tpu`` offers ten TPU kernels behind its ``impl`` names
(``logmel_waveform_pallas``), ``use_pallas`` (``power_to_logmel``,
``logmel_features(_batch)``) and ``fft_impl``.  Here the port's
counterparts, on CPU tensors (so the plain versions of their CUDA kernels),
are held against ``sed_tpu``'s Pallas kernels in interpret mode on the same
numpy inputs.  Tolerances:
  * log-mel: <= 1e-4 dB (the repository's parity budget);
  * power and the packed FFT Z: abs error <= 1e-5 x the frame's peak, after
    mapping sed_tpu's (k2, k1) tile layout to natural bin order;
  * port 'fuse' against port 'roll': equal (K5's plain version is K1's then
    K2's).

Most inputs use the small config (n_fft 8192); 'rollraw' and 'rolledge'
need sed_tpu's production config (nfft >= 32768, n_samples % 128 == 0).
The sed_tpu runs, which dominate the time, are shared by module fixtures.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.ops import featurizer as jax_featurizer
from sed_tpu.ops import pallas_featurizer as jax_pallas
from sed_tpu.ops import stft as jax_stft
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer, stft

SMALL = dict(working_sample_rate=8000, time_margin=0.33)   # n_fft 8192, hop 2640
BIG_FB = dict(time_margin=0.7)   # n_fft 131072: a 33.6 MB padded filterbank in sed_tpu
ATOL_DB = 1e-4
REL_PEAK = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signals(n_sig: int, seconds: float, sr: int, seed: int) -> np.ndarray:
    """(n_sig, samples) f32 noise, the last signal with a 1 kHz tone added
    (the signals of the repository's other featurizer parity tests)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = 0.3 * rng.standard_normal((n_sig, n))
    x[-1] += 0.4 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / sr)
    return x.astype(np.float32)


def _natural(flat: np.ndarray, n: int) -> np.ndarray:
    """sed_tpu's flat (k2, k1) layout of an n-point transform (index
    k2*n1 + k1 holds bin n2*k1 + k2) -> natural bin order."""
    n1, n2, *_ = jax_stft._matmul_fft_constants(n)
    lead = flat.shape[:-1]
    return flat[..., :n].reshape(*lead, n2, n1).swapaxes(-1, -2).reshape(*lead, n)


def _within_frame_peak(got: np.ndarray, want: np.ndarray, peak: np.ndarray) -> None:
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= REL_PEAK * peak), float((err / peak).max())


@pytest.fixture(scope="module")
def small():
    """The small config's signals and sed_tpu's kernel outputs on them."""
    cfg = JaxSpectrogramConfig(**SMALL)
    sigs = _signals(2, 7, 8000, seed=0)
    x = jnp.asarray(sigs)
    ref = {impl: np.asarray(jax_pallas.logmel_waveform_pallas(x, cfg, impl=impl))
           for impl in ("roll", "roll_nodb", "slice", "fuse")}
    n_frames = ref["roll"].shape[1]
    # 'eo' and 'pack' as logmel_waveform_pallas composes them, sharing one
    # run of each kernel with the power and Z checks below.
    eo = jax_pallas.stft_eo_power_from_waveform_pallas(x, cfg, trim=False)
    s, rows, width = eo.shape
    ref["eo"] = np.asarray(jax_pallas._onesided_mel_from_power(
        eo.reshape(s * rows, width), cfg, True).reshape(s, rows, -1)[:, :n_frames])
    zr, zi = jax_pallas.stft_packed_from_waveform_pallas(x, cfg, trim=False)
    packed_power = jax_pallas.packed_power_onesided(zr, zi, cfg.nfft)
    ref["pack"] = np.asarray(jax_pallas._onesided_mel_from_power(
        packed_power.reshape(s * rows, -1), cfg, True).reshape(s, rows, -1)[:, :n_frames])
    return dict(sigs=sigs, logmel=ref, eo=np.asarray(eo)[:, :n_frames],
                zr=np.asarray(zr)[:, :n_frames], zi=np.asarray(zi)[:, :n_frames],
                packed_power=np.asarray(packed_power)[:, :n_frames])


@pytest.fixture(scope="module")
def production():
    """One 6 s production-config signal (the shortest 'rollraw' takes: one
    interior tile) and sed_tpu's raw-read outputs on it."""
    cfg = JaxSpectrogramConfig()
    sig = _signals(1, 6, 48000, seed=1)
    x = jnp.asarray(sig)
    return dict(
        sig=sig,
        rollraw=np.asarray(jax_pallas.logmel_waveform_pallas(x, cfg, impl="rollraw")),
        rolledge=np.asarray(jax_pallas.logmel_waveform_pallas(x, cfg, impl="rolledge")),
        raw_power=np.asarray(jax_pallas.stft_power_from_waveform_raw_pallas(x, cfg)))


@pytest.mark.parametrize("impl", ["roll", "roll_nodb", "slice", "eo", "pack", "fuse"])
def test_logmel_waveform_impl_matches_sed_tpu(small, impl):
    got = kernels.logmel_waveform(torch.from_numpy(small["sigs"]),
                                  SpectrogramConfig(**SMALL), impl=impl).numpy()
    want = small["logmel"][impl]
    assert got.shape == want.shape == (2, 22, 64)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DB)


@pytest.mark.parametrize("impl", ["rollraw", "rolledge"])
def test_raw_read_impls_match_sed_tpu(production, impl):
    got = kernels.logmel_waveform(torch.from_numpy(production["sig"]),
                                  SpectrogramConfig(), impl=impl).numpy()
    want = production[impl]
    assert got.shape == want.shape == (1, 19, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DB)


def test_fuse_equals_roll_and_every_k1_name_agrees(small):
    """sed_tpu pins fuse == roll bit for bit; so does the port.  The names
    whose counterpart is K1 give K1's power exactly."""
    cfg = SpectrogramConfig(**SMALL)
    x = torch.from_numpy(small["sigs"])
    roll = kernels.logmel_waveform(x, cfg, impl="roll")
    torch.testing.assert_close(kernels.logmel_waveform(x, cfg, impl="fuse"), roll,
                               rtol=0, atol=0)
    torch.testing.assert_close(kernels.logmel_waveform_fused(x, cfg), roll,
                               rtol=0, atol=0)
    power = kernels.wave_stft_power(x, kernels.stft_window(cfg, CPU), cfg.hop_size,
                                    cfg.nfft)
    for impl in ("roll", "roll_nodb", "slice"):
        torch.testing.assert_close(kernels.stft_power_from_waveform(x, cfg, impl),
                                   power, rtol=0, atol=0)
    torch.testing.assert_close(kernels.stft_eo_power_from_waveform(x, cfg), power,
                               rtol=0, atol=0)


def test_k8_rollraw_power_matches_sed_tpu(production):
    """K8 (impl 'rollraw') is K1: its one-sided power against sed_tpu's
    all-bins tile layout, mapped to natural order."""
    cfg = SpectrogramConfig()
    got = kernels.stft_power_from_waveform(torch.from_numpy(production["sig"]), cfg,
                                           impl="rollraw").numpy()
    want = _natural(production["raw_power"], cfg.nfft)[..., : cfg.freq_bins]
    _within_frame_peak(got, want, want.max(axis=-1, keepdims=True))


def test_k7_eo_power_matches_sed_tpu(small):
    """K7: columns 0..m-1 of sed_tpu's output are the half transform's tile
    layout, column m the Nyquist bin, the rest zero padding."""
    cfg = SpectrogramConfig(**SMALL)
    m = cfg.nfft // 2
    got = kernels.stft_eo_power_from_waveform(torch.from_numpy(small["sigs"]),
                                              cfg).numpy()
    eo = small["eo"]
    assert eo.shape[-1] == m + 128 and not eo[..., m + 1:].any()
    want = np.concatenate([_natural(eo, m), eo[..., m:m + 1]], axis=-1)
    assert got.shape == (2, 22, m + 1)
    _within_frame_peak(got, want, want.max(axis=-1, keepdims=True))


def test_k6_packed_fft_matches_sed_tpu(small):
    cfg = SpectrogramConfig(**SMALL)
    m = cfg.nfft // 2
    zr, zi = kernels.stft_packed_from_waveform(torch.from_numpy(small["sigs"]), cfg)
    want_r, want_i = _natural(small["zr"], m), _natural(small["zi"], m)
    assert zr.shape == zi.shape == (2, 22, m)
    peak = np.hypot(want_r, want_i).max(axis=-1, keepdims=True)
    _within_frame_peak(zr.numpy(), want_r, peak)
    _within_frame_peak(zi.numpy(), want_i, peak)


def test_packed_power_onesided_matches_sed_tpu_and_k1(small):
    """The unpack on natural-order Z against sed_tpu's on its tile layout,
    and against K1's power of the same frames."""
    cfg = SpectrogramConfig(**SMALL)
    m = cfg.nfft // 2
    zr, zi = torch.from_numpy(_natural(small["zr"], m)), torch.from_numpy(
        _natural(small["zi"], m))
    got = kernels.packed_power_onesided(zr, zi, cfg.nfft).numpy()
    jp = small["packed_power"]
    want = np.concatenate([_natural(jp, m), jp[..., m:m + 1]], axis=-1)
    peak = want.max(axis=-1, keepdims=True)
    _within_frame_peak(got, want, peak)
    k1 = kernels.wave_stft_power(torch.from_numpy(small["sigs"]),
                                 kernels.stft_window(cfg, CPU), cfg.hop_size, cfg.nfft)
    _within_frame_peak(k1.numpy(), want, peak)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kw,rows", [
    pytest.param(SMALL, (3, 7), id="small"),
    pytest.param({}, (5,), id="production"),
    pytest.param(BIG_FB, (3,), id="fb-over-24MB"),
])
def test_power_to_logmel_matches_sed_tpu(kw, rows, use_pallas):
    """use_pallas=True is K4 (sed_tpu: power_to_logmel_pallas, whose
    filterbank streams over K past 24 MB); False is the matmul path."""
    cfg, jcfg = SpectrogramConfig(**kw), JaxSpectrogramConfig(**kw)
    rng = np.random.default_rng(len(rows) + cfg.nfft)
    power = (rng.random(rows + (cfg.freq_bins,)) ** 4 * 1e3).astype(np.float32)
    power.reshape(-1, cfg.freq_bins)[1] = 0.0                     # -100 dB floor
    if use_pallas:
        fb_bytes = -(-cfg.freq_bins // 2048) * 2048 * 128 * 4
        assert (fb_bytes > 24 * 2**20) == (kw is BIG_FB)
        want = jax_pallas.power_to_logmel_pallas(jnp.asarray(power), jcfg)
    else:
        want = jax_featurizer.power_to_logmel(jnp.asarray(power), jcfg)
    kernels.reset_launch_counts()
    got = featurizer.power_to_logmel(torch.from_numpy(power), cfg, use_pallas).numpy()
    assert sum(kernels.LAUNCHES.values()) == 0
    assert got.shape == np.asarray(want).shape == rows + (64,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL_DB)


@pytest.mark.parametrize("use_pallas", [False, True, "full", "auto"])
@pytest.mark.parametrize("fft_impl", ["fft", "matmul", "auto"])
def test_logmel_features_batch_matches_sed_tpu(fft_impl, use_pallas):
    """Each fft_impl x use_pallas against sed_tpu's same call.  On the CPU
    sed_tpu resolves 'auto' to its XLA path and the port to K1 + K2 (plain
    versions here): both are within the budget of the same truth."""
    sigs = _signals(2, 4, 8000, seed=2)
    pcm = (np.clip(sigs, -1, 1) * 32767).astype(np.int16).T[None]   # (1, samples, 2)
    want = np.asarray(jax_featurizer.logmel_features_batch(
        jnp.asarray(pcm), JaxSpectrogramConfig(**SMALL), fft_impl, use_pallas))
    got = featurizer.logmel_features_batch(
        torch.from_numpy(pcm), SpectrogramConfig(**SMALL), fft_impl=fft_impl,
        use_pallas=use_pallas).numpy()
    assert got.shape == want.shape == (1, 2, 13, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DB)
    one = featurizer.logmel_features(torch.from_numpy(pcm[0]), SpectrogramConfig(**SMALL),
                                     fft_impl, use_pallas).numpy()
    np.testing.assert_allclose(one, got[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fft_impl", ["fft", "matmul"])
def test_stft_fft_impls_match_sed_tpu(fft_impl):
    cfg, jcfg = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
    y = _signals(1, 3, 8000, seed=3)[0]
    jre, jim = jax_stft.stft_realimag(jnp.asarray(y), jcfg, fft_impl)
    want = np.asarray(jre) + 1j * np.asarray(jim)
    re, im = stft.stft_realimag(torch.from_numpy(y), cfg, fft_impl)
    got = stft.stft(torch.from_numpy(y), cfg, fft_impl).numpy()
    assert got.shape == want.shape == (10, cfg.freq_bins)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= REL_PEAK * peak)
    np.testing.assert_array_equal(re.numpy() + 1j * im.numpy(), got)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_multichannel_functions_match_sed_tpu(use_pallas):
    cfg, jcfg = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
    wav = _signals(3, 2, 8000, seed=4).T.copy()                    # (samples, 3)
    spec = featurizer.multichannel_stft(torch.from_numpy(wav), cfg)
    jspec = jax_featurizer.multichannel_stft(jnp.asarray(wav), jcfg)
    assert spec.shape == jspec.shape == (3, 7, cfg.freq_bins)
    assert spec.dtype == torch.complex64
    peak = np.abs(np.asarray(jspec)).max(axis=-1, keepdims=True)
    assert np.all(np.abs(spec.numpy() - np.asarray(jspec)) <= REL_PEAK * peak)
    host = featurizer.multichannel_stft_host(wav, cfg, "matmul", device="cpu")
    jhost = jax_featurizer.multichannel_stft_host(wav, jcfg, "matmul")
    assert host.dtype == jhost.dtype
    assert np.all(np.abs(host - jhost) <= REL_PEAK * peak)
    np.testing.assert_array_equal(
        featurizer.multichannel_stft_host(torch.from_numpy(wav), cfg, "matmul"), host)

    got = featurizer.multichannel_complex_to_log_mel(spec, cfg, use_pallas).numpy()
    want = jax_featurizer.multichannel_complex_to_log_mel(jspec, jcfg, use_pallas)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL_DB)
    rows = np.abs(np.asarray(jspec))                              # real rows, squared
    got = featurizer.multichannel_complex_to_log_mel(torch.from_numpy(rows), cfg,
                                                     use_pallas).numpy()
    want = jax_featurizer.multichannel_complex_to_log_mel(jnp.asarray(rows), jcfg,
                                                          use_pallas)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL_DB)
    got = featurizer.realimag_to_log_mel(spec.real, spec.imag, cfg, use_pallas).numpy()
    want = jax_featurizer.realimag_to_log_mel(jnp.real(jspec), jnp.imag(jspec), jcfg,
                                              use_pallas)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL_DB)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without a card")
def test_multichannel_stft_host_asks_for_the_card_by_default():
    """A numpy waveform goes to 'cuda' unless the caller asks for the CPU:
    with no card it raises, and never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        featurizer.multichannel_stft_host(np.zeros((9000, 1), np.float32),
                                          SpectrogramConfig(**SMALL))


def test_resolve_pallas_and_default_fft_impl():
    cfg = SpectrogramConfig(**SMALL)
    assert featurizer.resolve_pallas("auto", cfg) == "full"
    assert featurizer.resolve_pallas("auto", SpectrogramConfig()) == "full"
    for v in ("full", True, False):
        assert featurizer.resolve_pallas(v, cfg) == v
    assert stft.default_fft_impl() == "fft"
    with pytest.raises(ValueError, match="fft_impl"):
        stft.stft(torch.zeros(9000), cfg, fft_impl="cufft")


def test_impl_table_names_every_sed_tpu_impl():
    """Every impl name sed_tpu's drivers take, except the profiling-only
    'roll_aligned_debug', has a row of kernels here."""
    assert set(kernels.IMPL_KERNELS) == {
        "roll", "roll_nodb", "slice", "rollraw", "rolledge", "eo", "pack", "fuse"}
    for names in kernels.IMPL_KERNELS.values():
        assert set(names) <= set(kernels.LAUNCHES)


_SHORT_PROD = torch.zeros(1, 5 * 48000)       # % 128 == 0, but no interior tile
_REFUSALS = [
    ("roll_aligned_debug", NotImplementedError, "roll_aligned_debug",
     lambda x, c: kernels.logmel_waveform(x, c, impl="roll_aligned_debug")),
    ("roll_aligned_debug-power", NotImplementedError, "roll_aligned_debug",
     lambda x, c: kernels.stft_power_from_waveform(x, c, impl="roll_aligned_debug")),
    ("unknown-impl", ValueError, "unknown impl",
     lambda x, c: kernels.logmel_waveform(x, c, impl="bogus")),
    ("mel-unknown", ValueError, "mel_precision",
     lambda x, c: kernels.logmel_waveform(x, c, mel_precision="fp8")),
    ("rollraw-small-nfft", ValueError, "nfft >= 32768",
     lambda x, c: kernels.logmel_waveform(x, c, impl="rollraw")),
    ("rolledge-small-nfft", ValueError, "nfft >= 32768",
     lambda x, c: kernels.logmel_waveform(x, c, impl="rolledge")),
    ("rollraw-samples", ValueError, "% 128",
     lambda x, c: kernels.stft_power_from_waveform_raw(
         torch.zeros(1, 6 * 48000 + 1), SpectrogramConfig())),
    ("rollraw-too-short", ValueError, "too short",
     lambda x, c: kernels.stft_power_from_waveform(_SHORT_PROD, SpectrogramConfig(),
                                                   impl="rollraw")),
    ("rolledge-too-short", ValueError, "too short",
     lambda x, c: kernels.logmel_waveform_rolledge(_SHORT_PROD, SpectrogramConfig())),
]


@pytest.mark.parametrize("case", [pytest.param(c[1:], id=c[0]) for c in _REFUSALS])
def test_refusals_by_name(case):
    exc, match, call = case
    with pytest.raises(exc, match=match):
        call(torch.zeros(1, 9000), SpectrogramConfig(**SMALL))


# Refused by name before the tiers were ported; each now runs as sed_tpu's
# does (tests/test_torch_featurizer_tiers.py holds the tiers' values).
_ONCE_REFUSED = [
    ("precision-bf16x3", lambda x, c: kernels.logmel_waveform(x, c, precision="bf16x3"),
     lambda x, c: kernels.power_to_logmel_cuda(kernels.wave_dft_power_bf16(
         x, kernels.stft_window(c, CPU), c.hop_size, c.nfft, "bf16x3"), c)),
    ("mel-bf16x1", lambda x, c: kernels.logmel_waveform(x, c, mel_precision="bf16x1"),
     lambda x, c: kernels.mel_log_plain(
         kernels.wave_stft_power(x, kernels.stft_window(c, CPU), c.hop_size, c.nfft)[0],
         kernels.mel_bands(c, CPU).dense, "bf16x1")[None]),
    # 'pack' and 'fuse' at a tier, 'fuse' at a bf16 mel: K6t, K5t and K5b
    # (tests/test_torch_fuse_pack_tiers.py holds their values).
    ("precision-bf16x1", lambda x, c: kernels.stft_packed_from_waveform(x, c, precision="bf16x1"),
     lambda x, c: kernels.wave_packed_fft_bf16(x, kernels.stft_window(c, CPU), c.hop_size,
                                               c.nfft, "bf16x1")),
    ("precision-bf16x6", lambda x, c: kernels.logmel_waveform(x, c, impl="fuse",
                                                              precision="bf16x6"),
     lambda x, c: kernels.logmel_waveform(x, c, impl="roll", precision="bf16x6")),
    ("mel-bf16x3", lambda x, c: kernels.logmel_waveform_fused(x, c, mel_precision="bf16x3"),
     lambda x, c: kernels.logmel_waveform(x, c, mel_precision="bf16x3")),
    # sed_tpu's use_pallas=True path (STFT then the mel kernel) ignores the tier.
    ("features-tier", lambda x, c: featurizer.logmel_features_batch(
        x[..., None], c, use_pallas=True, pallas_precision="fast")[:, 0],
     lambda x, c: featurizer.logmel_features_batch(x[..., None], c, use_pallas=True)[:, 0]),
]


@pytest.mark.parametrize("case", [pytest.param(c[1:], id=c[0]) for c in _ONCE_REFUSED])
def test_reduced_tiers_once_refused_by_name(case):
    call, want = case
    x = torch.from_numpy(_signals(1, 2, 8000, seed=7))
    cfg = SpectrogramConfig(**SMALL)
    torch.testing.assert_close(call(x, cfg), want(x, cfg), rtol=0, atol=0)


def test_parity_precision_names_are_accepted():
    cfg = SpectrogramConfig(**SMALL)
    x = torch.from_numpy(_signals(1, 2, 8000, seed=5))
    want = kernels.logmel_waveform(x, cfg)
    for mel_precision in (None, "bf16x4"):
        for impl in ("roll", "fuse"):
            got = kernels.logmel_waveform(x, cfg, impl=impl, precision=None,
                                          mel_precision=mel_precision)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
