"""sed_tpu's reduced-precision featurizer tiers in the port, on the CPU.

The tiers ('fast' = bf16x3, 'turbo' = bf16x1, the raw 'bf16xN' strings and
per-stage (inner, outer) pairs) split every product of sed_tpu's two-stage
matmul DFT (n_fft = n1 * n2) into bf16 chunks (``_make_dot``).  On a CPU
tensor the port runs the plain versions of its bf16 tensor-core kernels
(K1t for waveforms, K3t for pre-framed rows, K2's bf16 product modes), held
here, on numpy inputs from a seed at the 8 kHz config (n_fft 8192, n1 64,
n2 128), against:

  * a float64 numpy emulation of the same rounding points (bf16 chunks by
    round to nearest even; each product term summed exactly and rounded to
    f32, terms added in f32 in sed_tpu's order; the f32 twiddle multiply;
    |Z|^2 in f32): <= 1e-6 x the frame's peak power, where the only freedom
    left is the order of a float64 sum (0 measured, every tier);
  * sed_tpu's Pallas kernels in interpret mode at the same tier: <= 2e-5 x
    the frame's peak power at bf16x3, bf16x4, bf16x6 and their pairs.  Not
    bit for bit: on the CPU sed_tpu's Precision.DEFAULT dot computes in
    float32, so its lo chunk (a - hi) stays f32 where the TPU's matrix unit,
    and the port, round it to bf16 (6.0e-6 measured at bf16x3, 7.4e-6 at
    bf16x4);
  * turbo (bf16x1 in either stage): on the CPU sed_tpu's DEFAULT dot is full
    float32, so its turbo is its parity (1.5e-5 of float64 against 0.137 for
    bf16 operands).  The port's turbo is held to the emulation above, and to
    sed_tpu's output within the turbo class: <= 2e-2 x the frame's peak in
    power and <= 0.05 dB in log-mel on broadband noise (measured 5.5e-3 and
    0.017 dB; sed_tpu's hardware record for turbo: 0.016 dB,
    benchmarks/FAST_FEATURIZER.json);
  * the fast class in log-mel (<= 1e-3 dB, sed_tpu's record 2.3e-5 dB) where
    sed_tpu rounds elsewhere ('eo' packs even and odd samples: 2.7e-5 dB
    measured), and K2's bf16x3 mode (2.3e-5 dB); K2's bf16x1 mode within the
    turbo class (0.013 dB measured), as sed_tpu's mel at bf16x1 is, on the
    CPU, its f32 mel.

``kernels.mode_fraction``, the card's check that a kernel runs the mode it
was asked for, tells each mode from the next with a float32-summed stand-in
of the kernels' sums.

Scores and the live paths: ``make_batch_predictor`` at each tier against
sed_tpu's (whose CPU 'auto' featurizer is XLA, which ignores the tier, as on
the port's PyTorch-ops path): fast <= 1e-4, turbo <= 2e-3 (sed_tpu's
record: 0 and 6.2e-4).  A ``StreamPool`` and a ``DeviceStreamingDetector``
(the ``RingTick``) at turbo equal the batch path at turbo within the
streaming budget, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.configs import SpectrogramConfig as JaxSpectrogramConfig
from sed_tpu.ops import featurizer as jax_featurizer
from sed_tpu.ops import pallas_featurizer as jax_pallas
from sed_tpu.ops import stft as jax_stft
from sed_tpu_torch import device_streaming
from sed_tpu_torch.configs import SpectrogramConfig
from sed_tpu_torch.inference import make_batch_predictor
from sed_tpu_torch.models.cnn import CnnAvgPooling
from sed_tpu_torch.ops import cuda_featurizer as kernels
from sed_tpu_torch.ops import featurizer
from sed_tpu_torch.stream_pool import StreamPool

SMALL = dict(working_sample_rate=8000, time_margin=0.33)   # n_fft 8192, hop 2640
CFG, JCFG = SpectrogramConfig(**SMALL), JaxSpectrogramConfig(**SMALL)
N, HOP = CFG.nfft, CFG.hop_size
EMULATION = 1e-6       # x the frame's peak power
SED_TPU = 2e-5         # x the frame's peak power, bf16x3/x4/x6 and their pairs
TURBO_POWER = 2e-2     # x the frame's peak power
TURBO_DB, FAST_DB, PARITY_DB = 0.05, 1e-3, 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def signals(n_sig=2, seconds=4, sr=8000, seed=0) -> np.ndarray:
    """(n_sig, samples) f32 noise, the last signal with a 1 kHz tone added."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = 0.3 * rng.standard_normal((n_sig, n))
    x[-1] += 0.4 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / sr)
    return x.astype(np.float32)


X = signals()


def natural(flat: np.ndarray) -> np.ndarray:
    """sed_tpu's (k2, k1) layout of all n_fft bins (index k2*n1 + k1 holds
    bin n2*k1 + k2) -> the one-sided bins in natural order."""
    n1, n2, *_ = jax_stft._matmul_fft_constants(N)
    k2 = np.arange(n2)[:, None]
    k1 = np.arange(n1)[None, :]
    out = np.empty_like(flat)
    out[..., (n2 * k1 + k2).reshape(-1)] = flat
    return out[..., : N // 2 + 1]


def rel_peak(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / want.max(-1, keepdims=True)).max())


# ---------------------------------------------------------------------------
# A float64 numpy emulation of the tiers' rounding points
# ---------------------------------------------------------------------------

def bf16_rne(a: np.ndarray) -> np.ndarray:
    """f32 -> the f32 value of its bf16 rounding, to nearest even, by bits."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def emulated_dot(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    chunks = 1 if passes == 1 else 3 if passes == 6 else 2

    def split(v):
        out = []
        for _ in range(chunks):
            c = bf16_rne(v)
            out.append(c)
            v = (v - c).astype(np.float32)
        return out

    ca, cb = split(np.asarray(a, np.float32)), split(np.asarray(b, np.float32))
    terms = ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (0, 2))[:passes]
    out = None
    for i, j in terms:
        d = np.matmul(ca[i].astype(np.float64), cb[j].astype(np.float64)).astype(np.float32)
        out = d if out is None else (out + d).astype(np.float32)
    return out


def emulated_power(frames: np.ndarray, passes) -> np.ndarray:
    """(rows, n_fft) windowed f32 frames -> (rows, n_fft/2 + 1) one-sided
    power, from sed_tpu's own f32 constants."""
    inner, outer = passes
    n1, n2, (w2r, w2i), (w1r, w1i), (twr, twi) = jax_stft._matmul_fft_constants(N)
    x = frames.reshape(len(frames), n2, n1)
    yr, yi = emulated_dot(w2r, x, inner), emulated_dot(w2i, x, inner)
    tr = yr * twr - yi * twi
    ti = yr * twi + yi * twr
    zr = emulated_dot(tr, w1r, outer) - emulated_dot(ti, w1i, outer)
    zi = emulated_dot(tr, w1i, outer) + emulated_dot(ti, w1r, outer)
    power = zr * zr + zi * zi                       # (rows, k2, k1)
    return natural(power.reshape(len(frames), N))


def windowed_frames(x: np.ndarray) -> np.ndarray:
    """Centred, reflect-padded frames of every signal times sed_tpu's
    padded window, f32: (n_sig * n_frames, n_fft)."""
    window = jax_stft.padded_window(CFG.frame_size, N).astype(np.float32)
    padded = np.pad(x, ((0, 0), (N // 2, N // 2)), mode="reflect")
    n_frames = 1 + x.shape[1] // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N)[None, :]
    return (padded[:, idx] * window).reshape(-1, N).astype(np.float32)


PASSES = {"bf16x1": (1, 1), "bf16x3": (3, 3), "bf16x4": (4, 4), "bf16x6": (6, 6),
          ("bf16x1", "bf16x6"): (1, 6), (None, "bf16x3"): (6, 3)}


@pytest.mark.parametrize("precision", list(PASSES), ids=str)
def test_wave_tier_plain_matches_the_float64_emulation(precision):
    got = kernels.wave_dft_power_bf16(torch.from_numpy(X), kernels.stft_window(CFG, CPU),
                                      HOP, N, precision).numpy()
    assert kernels.tier_passes(precision) == PASSES[precision]
    want = emulated_power(windowed_frames(X), PASSES[precision]).reshape(got.shape)
    assert rel_peak(got, want) <= EMULATION


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("precision", ["bf16x1", "bf16x3"])
def test_rows_tier_plain_matches_the_float64_emulation(precision, dtype):
    """K3t's plain version on pre-framed rows; int16 rows are PCM16, the
    window scaled by 1/32768 (exact)."""
    rng = np.random.default_rng(4)
    rows = (0.3 * rng.standard_normal((5, N))).astype(np.float32)
    if dtype == "int16":
        rows = (rows * 8000).astype(np.int16)
    got = kernels.frames_dft_power_bf16(torch.from_numpy(rows), kernels.stft_window(CFG, CPU),
                                        N, precision).numpy()
    window = jax_stft.padded_window(CFG.frame_size, N).astype(np.float32)
    if dtype == "int16":
        window = window / np.float32(32768.0)
    want = emulated_power(rows.astype(np.float32) * window, PASSES[precision])
    assert got.shape == (5, N // 2 + 1)
    assert rel_peak(got, want) <= EMULATION


# ---------------------------------------------------------------------------
# Against sed_tpu's Pallas kernels at the same tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_power():
    """sed_tpu's K1 (impl 'roll', interpret mode) at a precision, natural
    one-sided order; each computed once."""
    cache = {}

    def get(precision):
        if precision not in cache:
            out = jax_pallas.stft_power_from_waveform_pallas(jnp.asarray(X), JCFG, impl="roll",
                                                             precision=precision)
            cache[precision] = natural(np.asarray(out))
        return cache[precision]

    return get


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x4", "bf16x6", ("bf16x6", "bf16x3"),
                                       ("bf16x3", None)], ids=str)
def test_wave_tier_plain_matches_sed_tpu(precision, jax_power):
    got = kernels.stft_power_from_waveform(torch.from_numpy(X), CFG, "roll", precision).numpy()
    assert rel_peak(got, jax_power(precision)) <= SED_TPU


def test_rows_tier_plain_matches_sed_tpu_at_fast():
    """K3t's plain version against sed_tpu's ``stft_power_pallas`` on int16
    rows, and its log-mel (K3t then K2) against ``logmel_frames_pallas``."""
    rng = np.random.default_rng(6)
    rows = (0.3 * rng.standard_normal((6, N)) * 8000).astype(np.int16)
    got = kernels.frames_dft_power_bf16(torch.from_numpy(rows), kernels.stft_window(CFG, CPU),
                                        N, "bf16x3").numpy()
    want = natural(np.asarray(jax_pallas.stft_power_pallas(jnp.asarray(rows), JCFG,
                                                           precision="bf16x3")))
    assert rel_peak(got, want) <= SED_TPU
    mel = featurizer.logmel_frames(torch.from_numpy(rows), CFG, "bf16x3").numpy()
    want_mel = np.asarray(jax_pallas.logmel_frames_pallas(jnp.asarray(rows), JCFG,
                                                          precision="bf16x3"))
    np.testing.assert_allclose(mel, want_mel, rtol=0, atol=FAST_DB)


@pytest.mark.parametrize("precision", ["bf16x1", ("bf16x1", "bf16x3"), (None, "bf16x1")],
                         ids=str)
def test_turbo_is_within_its_class_of_sed_tpu(precision, jax_power):
    """On the CPU sed_tpu's turbo is its parity: the port's turbo (held to the
    emulation above) is within the turbo class of it."""
    x = torch.from_numpy(X)
    got = kernels.stft_power_from_waveform(x, CFG, "roll", precision).numpy()
    assert rel_peak(got, jax_power(None)) <= TURBO_POWER
    mel = kernels.logmel_waveform(x[:1], CFG, precision=precision).numpy()  # the noise
    want = np.asarray(jax_pallas.logmel_waveform_pallas(jnp.asarray(X[:1]), JCFG))
    np.testing.assert_allclose(mel, want, rtol=0, atol=TURBO_DB)


def test_eo_and_rolledge_at_a_tier_are_in_its_class():
    """'eo' and 'rolledge' run K1t at a reduced tier, as 'roll' does (equal
    to it here); against sed_tpu's own 'eo' (its even/odd packing rounds
    elsewhere) and 'rolledge' at bf16x3 within the fast class.  'rolledge'
    needs sed_tpu's production config."""
    x = torch.from_numpy(X)
    roll = kernels.logmel_waveform(x, CFG, impl="roll", precision="bf16x3")
    eo = kernels.logmel_waveform(x, CFG, impl="eo", precision="bf16x3")
    assert torch.equal(eo, roll)
    want = np.asarray(jax_pallas.logmel_waveform_pallas(jnp.asarray(X), JCFG, impl="eo",
                                                        precision="bf16x3"))
    np.testing.assert_allclose(eo.numpy(), want, rtol=0, atol=FAST_DB)

    prod, jprod = SpectrogramConfig(), JaxSpectrogramConfig()
    y = signals(1, 6, 48000, seed=2)
    edge = kernels.logmel_waveform(torch.from_numpy(y), prod, impl="rolledge", precision="bf16x3")
    assert torch.equal(edge, kernels.logmel_waveform(torch.from_numpy(y), prod,
                                                     precision="bf16x3"))
    want = np.asarray(jax_pallas.logmel_waveform_pallas(jnp.asarray(y), jprod, impl="rolledge",
                                                        precision="bf16x3"))
    np.testing.assert_allclose(edge.numpy(), want, rtol=0, atol=FAST_DB)


def test_slice_ignores_the_precision():
    """sed_tpu's slice kernel has no precision: its output at turbo is its
    parity output, and so is the port's (K1)."""
    x = torch.from_numpy(X)
    got = kernels.logmel_waveform(x, CFG, impl="slice", precision="bf16x1")
    assert torch.equal(got, kernels.logmel_waveform(x, CFG))
    want = np.asarray(jax_pallas.logmel_waveform_pallas(jnp.asarray(X), JCFG, impl="slice",
                                                        precision="bf16x1"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PARITY_DB)


@pytest.mark.parametrize("mel_precision", ["bf16x1", "bf16x3"])
def test_mel_precision_modes(mel_precision):
    """K2's bf16 product modes on the roll family: the plain version against
    a float64 emulation of its rounding points (power and weights split into
    bf16 chunks, each product term summed exactly and rounded to f32;
    <= 1e-5 dB), and against sed_tpu's ``logmel_waveform_pallas(
    mel_precision=)`` within the class (bf16x1: its CPU mel is f32, <= 0.05
    dB; bf16x3 <= 1e-3 dB)."""
    x = torch.from_numpy(X)
    got = kernels.logmel_waveform(x, CFG, mel_precision=mel_precision).numpy()
    power = kernels.wave_stft_power(x, kernels.stft_window(CFG, CPU), HOP, N).numpy()
    fb = kernels.mel_bands(CFG, CPU).dense.numpy()
    melp = emulated_dot(power.reshape(-1, power.shape[-1]), fb,
                        kernels.TIER_PASSES[mel_precision])
    emulated = 10.0 * np.log10(np.maximum(melp.astype(np.float64), 1e-10))
    np.testing.assert_allclose(got.reshape(emulated.shape), emulated, rtol=0, atol=1e-5)
    want = np.asarray(jax_pallas.logmel_waveform_pallas(jnp.asarray(X), JCFG,
                                                        mel_precision=mel_precision))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TURBO_DB if mel_precision == "bf16x1" else FAST_DB)


# ---------------------------------------------------------------------------
# Telling a mode from the next: kernels.mode_fraction
# ---------------------------------------------------------------------------

STAND_IN_FRACTION = 0.05   # the card's checks take 0.5 (tests/test_torch_cuda.py, chip_smoke.py)


def float32_summed(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """A stand-in of the kernels' products: ``tier_matmul``'s bf16 chunks,
    each product term and the terms summed in float32 (the tensor cores'
    and K2's accumulator) where the plain version sums exactly."""
    n = kernels._tier_chunks(passes)
    ca, cb = kernels.split_bf16(a.float(), n), kernels.split_bf16(b.float(), n)
    out = sum(torch.matmul(ca[i], cb[j]) for i, j in kernels._TIER_TERMS[:passes])
    return out.to(a.dtype)


def wave_tier(precision) -> torch.Tensor:
    return kernels.wave_dft_power_bf16_plain(torch.from_numpy(X), kernels.stft_window(CFG, CPU),
                                             HOP, N, precision)


def mel_tier(mel_precision) -> torch.Tensor:
    power = kernels.wave_stft_power(torch.from_numpy(X), kernels.stft_window(CFG, CPU), HOP, N)
    return kernels.mel_log_plain(power.reshape(-1, CFG.freq_bins).double(),
                                 kernels.mel_bands(CFG, CPU).dense.double(), mel_precision)


@pytest.mark.parametrize("stage, mode, neighbour", [
    ("dft", "bf16x3", "bf16x4"), ("dft", "bf16x3", ("bf16x1", "bf16x3")),
    ("dft", "bf16x1", ("bf16x3", "bf16x1")), ("dft", "bf16x1", ("bf16x1", "bf16x3")),
    ("dft", "bf16x4", "bf16x3"), ("dft", "bf16x4", "bf16x6"), ("dft", "bf16x6", "bf16x4"),
    ("dft", ("bf16x1", "bf16x3"), "bf16x3"), ("dft", ("bf16x1", "bf16x3"), "bf16x1"),
    ("dft", ("bf16x6", "bf16x4"), "bf16x4"),
    ("mel", "bf16x1", "bf16x3"), ("mel", "bf16x3", None), ("mel", "bf16x3", "bf16x1")],
    ids=str)
def test_mode_fraction_tells_each_mode_from_the_next(stage, mode, neighbour, monkeypatch):
    """The check that the card's kernels run the mode they were asked for:
    a stand-in summed in float32 lies within 0.05 of its own mode's plain
    version along the line to the next mode's (measured 0.0151 at most), and
    the stand-in at the next mode within 0.05 of that one (0.9849 at least),
    though at bf16x3 against bf16x4 the gap between the modes' plain
    versions (~5e-6 x the frame's peak) is smaller than the largest float32
    noise of the sums at any one bin.  The tensor cores' float32 sums keep
    only part of such small terms, so the card's checks ask only that a
    kernel lie nearer its own mode (0.5)."""
    plain = wave_tier if stage == "dft" else mel_tier
    want, other = plain(mode), plain(neighbour)
    monkeypatch.setattr(kernels, "tier_matmul", float32_summed)
    own = plain(mode)
    wrong = other if neighbour is None else plain(neighbour)
    scale = want.amax(dim=-1, keepdim=True) if stage == "dft" else None
    assert not torch.equal(own, want)
    assert abs(kernels.mode_fraction(own, want, other, scale)) <= STAND_IN_FRACTION
    assert kernels.mode_fraction(wrong, want, other, scale) >= 1 - STAND_IN_FRACTION


@pytest.mark.parametrize("name", [None, "parity", "fast", "turbo", "bf16x1", "bf16x3",
                                  "bf16x4", "bf16x6"])
def test_tier_names_resolve_as_sed_tpu(name):
    want = jax_featurizer.resolve_featurizer_precision(name)
    assert featurizer.resolve_featurizer_precision(name) == want
    assert dict(featurizer.FEATURIZER_PRECISION_TIERS) == dict(
        jax_featurizer.FEATURIZER_PRECISION_TIERS)


@pytest.mark.parametrize("name", ["bogus", "bf16x2", "FAST"])
def test_unknown_tier_names_raise_sed_tpu_error(name):
    with pytest.raises(ValueError) as want:
        jax_featurizer.resolve_featurizer_precision(name)
    with pytest.raises(ValueError) as got:
        featurizer.resolve_featurizer_precision(name)
    assert str(got.value) == str(want.value)


def test_reduced_tiers_refused_on_fuse_and_pack_only():
    """Once the calls refused: 'fuse' and 'pack' at a reduced tier and 'fuse'
    at a bf16 mel_precision now compute (K5t, K6t, K5b; their values in
    test_torch_fuse_pack_tiers.py), and every impl name has a row at a
    reduced tier.  What stays refused is an unknown precision."""
    x = torch.from_numpy(X[:1])
    for precision in ("bf16x3", "bf16x1"):
        assert torch.equal(kernels.logmel_waveform(x, CFG, impl="fuse", precision=precision),
                           kernels.logmel_waveform(x, CFG, impl="roll", precision=precision))
    assert torch.equal(kernels.logmel_waveform_fused(x, CFG, mel_precision="bf16x1"),
                       kernels.logmel_waveform(x, CFG, mel_precision="bf16x1"))
    zr, zi = kernels.stft_packed_from_waveform(x, CFG, ("bf16x3", None))
    assert zr.shape == zi.shape == (1, 1 + x.shape[1] // HOP, N // 2)
    packed = kernels.logmel_waveform(x, CFG, impl="pack", precision="bf16x1")
    assert packed.shape == (1, 1 + x.shape[1] // HOP, CFG.mel_bins)
    assert bool(torch.isfinite(packed).all())
    # 'pack' ignores mel_precision, as sed_tpu's pack path does.
    assert torch.equal(kernels.logmel_waveform(x, CFG, impl="pack", mel_precision="bf16x1"),
                       kernels.logmel_waveform(x, CFG, impl="pack"))
    with pytest.raises(ValueError, match="featurizer precision"):
        kernels.logmel_waveform(x, CFG, precision="bf16x2")
    assert set(kernels.REDUCED_IMPL_KERNELS) == set(kernels.IMPL_KERNELS)
    for names in kernels.REDUCED_IMPL_KERNELS.values():
        assert set(names) <= set(kernels.LAUNCHES)


def test_cpu_tiers_launch_no_kernel():
    kernels.reset_launch_counts()
    x = torch.from_numpy(X[:1])
    kernels.logmel_waveform(x, CFG, precision="bf16x1", mel_precision="bf16x3")
    featurizer.logmel_frames(torch.zeros(2, N), CFG, "bf16x3")
    assert sum(kernels.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# Scores and the live paths
# ---------------------------------------------------------------------------

NARROW = ((8, 2), (16, 1))


@pytest.fixture(scope="module")
def narrow_models():
    """A flax CnnAvgPooling and the port's with the same weights."""
    import jax

    from sed_tpu.models.cnn import CnnAvgPooling as FlaxCnnAvgPooling
    from sed_tpu_torch.models.convert import cnn_avg_pooling_state_dict

    flax_model = FlaxCnnAvgPooling(classes_num=1, model_config=NARROW)
    variables = flax_model.init(jax.random.key(0), jnp.zeros((1, 31, 64, 1)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    port = CnnAvgPooling(1, NARROW)
    port.load_state_dict(cnn_avg_pooling_state_dict(params, stats), strict=True)
    return flax_model, params, stats, port


@pytest.mark.parametrize("tier, atol", [("parity", 1e-5), ("fast", 1e-4), ("turbo", 2e-3)])
def test_batch_predictor_scores_at_each_tier_match_sed_tpu(tier, atol, narrow_models):
    from sed_tpu.inference import make_batch_predictor as jax_make_batch_predictor

    flax_model, params, stats, port = narrow_models
    x = (np.clip(signals(2, 10, seed=8)[..., None], -1, 1) * 32767).astype(np.int16)
    want = np.asarray(jax_make_batch_predictor(flax_model, JCFG, featurizer_precision=tier)(
        params, stats, jnp.asarray(x)))
    got = make_batch_predictor(port, CFG, featurizer_precision=tier, device="cpu")(x).numpy()
    assert got.shape == want.shape == (2, 30, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_stream_pool_and_ring_tick_at_turbo_equal_the_batch_path(narrow_models):
    """Two streams through a ``StreamPool`` and through a
    ``DeviceStreamingDetector`` (host startup, then the ``RingTick``), both
    at turbo, against ``make_batch_predictor`` at turbo on the whole audio
    (the streams emit whole strides of 8 frames: the batch's first ones)."""
    port = narrow_models[3]
    kernels.reset_launch_counts()
    kw = dict(chunk_samples=8000, halo=64, total_stride=8, bucket=64, device="cpu",
              featurizer_precision="turbo")
    ys = signals(2, 12, seed=9) * 0.5
    want = make_batch_predictor(port, CFG, featurizer_precision="turbo", device="cpu")(
        ys[..., None]).numpy()

    det = device_streaming.DeviceStreamingDetector(port, CFG, batch=2, **kw)
    blocks = [det.push(ys[:, i:i + 8000]) for i in range(0, ys.shape[1], 8000)]
    assert det._device_mode
    got = np.concatenate(blocks + [det.flush()], axis=1)
    assert want.shape[1] - 8 < got.shape[1] <= want.shape[1]   # whole strides
    np.testing.assert_allclose(got, want[:, : got.shape[1]], rtol=0, atol=1e-5)

    pool = StreamPool(port, CFG, slots=2, **kw)
    slots = [pool.join(), pool.join()]
    outs = {s: [] for s in slots}
    for i in range(0, ys.shape[1], 8000):
        for s, block in pool.push({s: ys[k, i:i + 8000] for k, s in enumerate(slots)}).items():
            outs[s].append(block)
    for k, s in enumerate(slots):
        outs[s].append(pool.leave(s))
        got = np.concatenate([b for b in outs[s] if b.shape[0]], axis=0)
        assert want.shape[1] - 8 < got.shape[0] <= want.shape[1]
        np.testing.assert_allclose(got, want[k, : got.shape[0]], rtol=0, atol=1e-5)
    assert sum(kernels.LAUNCHES.values()) == 0
