"""'fuse' and 'pack' at sed_tpu's reduced-precision tiers, on the CPU.

sed_tpu runs both at every ``precision`` of its matmul DFT ('fast' bf16x3,
'turbo' bf16x1, 'bf16x4', 'bf16x6' and (inner, outer) pairs), and 'fuse'
also at its ``mel_precision`` 'bf16x1' / 'bf16x3'.  The port's kernels are
K5t (``wave_stft_mel_log_bf16``: K1t then K2 in one launch), K5b (K5 with
K2's product modes) and K6t (``wave_packed_fft_bf16``: the bf16 matmul DFT
of the m = n_fft/2 packed points z = x_even + i*x_odd).  On a CPU tensor
their plain versions run; here, on numpy inputs from a seed at the 8 kHz
config (n_fft 8192: K5t n1 64 / n2 128; K6t m 4096, n1 = n2 = 64), they are
held against:

  * a float64 numpy emulation of sed_tpu's rounding points (the bf16
    chunks, each product term summed exactly and rounded to f32, the terms
    and the complex parts added in f32 in sed_tpu's order): K6t's Z within
    1e-6 x the frame's peak |Z| (``EMULATION``); K5t's and K5b's log-mel
    within 1e-5 dB of the emulated power through the emulated mel (the
    bound of K2's modes' emulation in ``test_torch_featurizer_tiers.py``);
  * the port's two-kernel paths: 'fuse' equals 'roll' at the same
    precision and mel_precision bit for bit (K5t = K1t then K2, K5b = K1
    then K2's mode), as sed_tpu pins fuse == roll;
  * sed_tpu's kernels in interpret mode (each run takes seconds, so one or
    two a class), within the classes of ``test_torch_featurizer_tiers.py``:
    K6t's Z and one-sided power (after the hermitian unpack) within 2e-5 x
    the frame's peak at bf16x3 and bf16x6 (measured 4.4e-6 and 2.1e-7 of
    peak |Z| for Z; 4.1e-6 at bf16x4); turbo within 2e-2 x peak, since on
    the CPU sed_tpu's DEFAULT dot computes in float32 and its turbo is its
    parity (Z 3.4e-3 of peak; 2.2e-3 at (bf16x1, bf16x3)); log-mel in the
    fast class (1e-3 dB) where no stage or mel is bf16x1 (measured 2.7e-5 dB
    at fast, 2.3e-5 at mel bf16x3), in the turbo class (0.05 dB) otherwise
    (0.020 dB at turbo with mel bf16x3, 0.013 dB at mel bf16x1).

``kernels.mode_fraction``, the card's check that K6t runs the mode it was
asked for, tells each of its modes from the next with a float32-summed
stand-in of the kernel's sums, as the tiers file does for K1t.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.ops import pallas_featurizer as jax_pallas
from sed_tpu.ops import stft as jax_stft
from sed_tpu_torch.ops import cuda_featurizer as kernels
from test_torch_featurizer_tiers import (
    CFG, EMULATION, FAST_DB, HOP, JCFG, N, SED_TPU, STAND_IN_FRACTION, TURBO_DB, TURBO_POWER,
    X, emulated_dot, emulated_power, float32_summed, rel_peak, windowed_frames)

CPU = torch.device("cpu")
M = N // 2
MEL_EMULATION_DB = 1e-5
PRECISIONS = ["bf16x3", "bf16x1", "bf16x4", "bf16x6", ("bf16x1", "bf16x3")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def turbo_class(precision, mel_precision=None) -> bool:
    """A bf16x1 stage or mel: on the CPU sed_tpu computes it in float32."""
    stages = precision if isinstance(precision, tuple) else (precision,)
    return "bf16x1" in stages or mel_precision == "bf16x1"


def natural_m(flat: np.ndarray) -> np.ndarray:
    """sed_tpu's (k2, k1) layout of the m-point packed transform -> natural
    bin order."""
    n1, n2, *_ = jax_stft._matmul_fft_constants(M)
    lead = flat.shape[:-1]
    return flat[..., :M].reshape(*lead, n2, n1).swapaxes(-1, -2).reshape(*lead, M)


def emulated_packed(frames: np.ndarray, passes):
    """(rows, n_fft) windowed f32 frames -> (Zr, Zi), each (rows, m) in
    natural order: sed_tpu's packed kernel from its own m-point constants."""
    inner, outer = passes
    n1, n2, (w2r, w2i), (w1r, w1i), (twr, twi) = jax_stft._matmul_fft_constants(M)
    xr, xi = (frames[:, h::2].reshape(-1, n2, n1) for h in (0, 1))
    yr = emulated_dot(w2r, xr, inner) - emulated_dot(w2i, xi, inner)
    yi = emulated_dot(w2r, xi, inner) + emulated_dot(w2i, xr, inner)
    tr = yr * twr - yi * twi
    ti = yr * twi + yi * twr
    zr = emulated_dot(tr, w1r, outer) - emulated_dot(ti, w1i, outer)
    zi = emulated_dot(tr, w1i, outer) + emulated_dot(ti, w1r, outer)
    return tuple(z.swapaxes(-1, -2).reshape(-1, M) for z in (zr, zi))


def emulated_mel_db(power: np.ndarray, mel_precision) -> np.ndarray:
    """K2's function on float64: the f32 filterbank, the product exact
    (None) or at the mode's bf16 chunks (emulated_dot), 10 log10."""
    fb = kernels.mel_bands(CFG, CPU).dense.numpy()
    passes = kernels.mel_passes(mel_precision)
    melp = (power.astype(np.float64) @ fb.astype(np.float64) if passes == 0
            else emulated_dot(power, fb, passes).astype(np.float64))
    return 10.0 * np.log10(np.maximum(melp, 1e-10))


def window_cpu() -> torch.Tensor:
    return kernels.stft_window(CFG, CPU)


# ---------------------------------------------------------------------------
# The plain versions against the float64 emulation and the two-kernel paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS, ids=str)
def test_packed_tier_plain_matches_the_float64_emulation(precision):
    zr, zi = kernels.wave_packed_fft_bf16(torch.from_numpy(X), window_cpu(), HOP, N, precision)
    assert zr.shape == zi.shape == (2, 1 + X.shape[1] // HOP, M)
    wr, wi = emulated_packed(windowed_frames(X), kernels.tier_passes(precision))
    peak = np.hypot(wr, wi).max(-1, keepdims=True)
    for got, want in ((zr, wr), (zi, wi)):
        err = np.abs(got.numpy().reshape(want.shape).astype(np.float64) - want)
        assert float((err / peak).max()) <= EMULATION


@pytest.mark.parametrize("precision, mel_precision", [
    ("bf16x3", None), ("bf16x1", None), ("bf16x4", "bf16x4"), ("bf16x6", None),
    (("bf16x1", "bf16x3"), None), (None, "bf16x1"), (None, "bf16x3"), ("bf16x1", "bf16x1"),
    ("bf16x1", "bf16x3")], ids=str)
def test_fuse_plain_equals_roll_and_the_float64_emulation(precision, mel_precision):
    """K5t's (K5b's at precision None) plain version: 'roll' at the same
    precision and mel_precision bit for bit, and the emulated power through
    the emulated mel within 1e-5 dB."""
    x = torch.from_numpy(X)
    got = kernels.logmel_waveform(x, CFG, impl="fuse", precision=precision,
                                  mel_precision=mel_precision)
    roll = kernels.logmel_waveform(x, CFG, impl="roll", precision=precision,
                                   mel_precision=mel_precision)
    assert torch.equal(got, roll)
    frames = windowed_frames(X)
    passes = kernels.tier_passes(precision)
    power = (emulated_power(frames, passes) if passes else
             kernels.wave_stft_power(x, window_cpu(), HOP, N).reshape(len(frames), -1).numpy())
    want = emulated_mel_db(power, mel_precision)
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want, rtol=0,
                               atol=MEL_EMULATION_DB)


def test_pack_at_a_tier_is_its_power_through_the_parity_mel():
    """'pack' at a tier: K6t, the hermitian unpack, K2 at its parity mode
    (mel_precision does not reach it, as in sed_tpu); its power is K1t's
    class of the same tier."""
    x = torch.from_numpy(X)
    zr, zi = kernels.stft_packed_from_waveform(x, CFG, "bf16x3")
    power = kernels.packed_power_onesided(zr, zi, N)
    want = kernels.power_to_logmel_cuda(power, CFG)
    for mel_precision in (None, "bf16x1"):
        got = kernels.logmel_waveform(x, CFG, impl="pack", precision="bf16x3",
                                      mel_precision=mel_precision)
        assert torch.equal(got, want)
    k1t = kernels.wave_dft_power_bf16(x, window_cpu(), HOP, N, "bf16x3")
    assert rel_peak(power.numpy(), k1t.numpy()) <= SED_TPU


# ---------------------------------------------------------------------------
# Against sed_tpu's Pallas kernels at the same tier (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_packed():
    """sed_tpu's K6 at a precision: (Zr, Zi) in natural order and the one-
    sided power of its own hermitian unpack; each computed once."""
    cache = {}

    def get(precision):
        if precision not in cache:
            zr, zi = jax_pallas.stft_packed_from_waveform_pallas(jnp.asarray(X), JCFG,
                                                                 precision=precision)
            power = np.asarray(jax_pallas.packed_power_onesided(zr, zi, N))
            cache[precision] = (natural_m(np.asarray(zr)), natural_m(np.asarray(zi)),
                                np.concatenate([natural_m(power), power[..., M:]], axis=-1))
        return cache[precision]

    return get


# sed_tpu's interpret-mode runs take seconds each: one a class (the emulation
# above holds every precision's rounding points).
@pytest.mark.parametrize("precision", ["bf16x3", "bf16x6", "bf16x1"], ids=str)
def test_pack_plain_matches_sed_tpu(precision, jax_packed):
    x = torch.from_numpy(X)
    zr, zi = kernels.stft_packed_from_waveform(x, CFG, precision)
    power = kernels.packed_power_onesided(zr, zi, N).numpy()
    jr, ji, jpower = jax_packed(precision)
    bound = TURBO_POWER if turbo_class(precision) else SED_TPU
    peak = np.hypot(jr, ji).max(-1, keepdims=True)
    for got, want in ((zr, jr), (zi, ji)):
        assert float((np.abs(got.numpy() - want) / peak).max()) <= bound
    assert rel_peak(power, jpower) <= bound


def test_pack_logmel_within_the_fast_class_of_sed_tpu():
    got = kernels.logmel_waveform(torch.from_numpy(X[:1]), CFG, impl="pack",
                                  precision="bf16x3").numpy()
    want = np.asarray(jax_pallas.logmel_waveform_pallas(jnp.asarray(X[:1]), JCFG, impl="pack",
                                                        precision="bf16x3"))
    np.testing.assert_allclose(got, want, rtol=0, atol=FAST_DB)


@pytest.mark.parametrize("precision, mel_precision", [
    ("bf16x3", None), ("bf16x6", None), (("bf16x1", "bf16x3"), None), (None, "bf16x3"),
    ("bf16x1", "bf16x3")], ids=str)
def test_fuse_plain_matches_sed_tpu(precision, mel_precision):
    got = kernels.logmel_waveform(torch.from_numpy(X), CFG, impl="fuse", precision=precision,
                                  mel_precision=mel_precision).numpy()
    want = np.asarray(jax_pallas.logmel_waveform_pallas(
        jnp.asarray(X), JCFG, impl="fuse", precision=precision, mel_precision=mel_precision))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TURBO_DB if turbo_class(
        precision, mel_precision) else FAST_DB)


# ---------------------------------------------------------------------------
# K6t's modes told apart: kernels.mode_fraction
# ---------------------------------------------------------------------------

def packed_tier(precision) -> torch.Tensor:
    zr, zi = kernels.wave_packed_fft_bf16_plain(torch.from_numpy(X), window_cpu(), HOP, N,
                                                precision)
    return torch.cat([zr, zi], dim=-1)


@pytest.mark.parametrize("mode, neighbour", [
    ("bf16x3", "bf16x4"), ("bf16x3", ("bf16x1", "bf16x3")), ("bf16x1", ("bf16x3", "bf16x1")),
    ("bf16x1", ("bf16x1", "bf16x3")), ("bf16x4", "bf16x3"), ("bf16x4", "bf16x6"),
    ("bf16x6", "bf16x4"), (("bf16x1", "bf16x3"), "bf16x3"), (("bf16x1", "bf16x3"), "bf16x1")],
    ids=str)
def test_mode_fraction_tells_each_packed_mode_from_the_next(mode, neighbour, monkeypatch):
    """As for K1t (test_torch_featurizer_tiers.py): a float32-summed stand-in
    of K6t lies within 0.05 of its own mode's plain version along the line
    to the next mode's, and the stand-in at the next mode within 0.05 of
    that one; the card's checks ask only that the kernel lie nearer its own
    mode (0.5)."""
    want, other = packed_tier(mode), packed_tier(neighbour)
    monkeypatch.setattr(kernels, "tier_matmul", float32_summed)
    own, wrong = packed_tier(mode), packed_tier(neighbour)
    zr, zi = want.chunk(2, dim=-1)
    scale = torch.hypot(zr, zi).amax(dim=-1, keepdim=True)
    assert not torch.equal(own, want)
    assert abs(kernels.mode_fraction(own, want, other, scale)) <= STAND_IN_FRACTION
    assert kernels.mode_fraction(wrong, want, other, scale) >= 1 - STAND_IN_FRACTION


# ---------------------------------------------------------------------------
# What each call launches on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl, precision, mel_precision, names", [
    ("fuse", None, None, ("wave_stft_mel_log",)),
    ("fuse", None, "bf16x4", ("wave_stft_mel_log",)),
    ("fuse", None, "bf16x3", ("wave_stft_mel_log_mel_bf16",)),
    ("fuse", "bf16x1", None, ("wave_stft_mel_log_bf16",)),
    ("fuse", ("bf16x6", None), "bf16x1", ("wave_stft_mel_log_bf16",)),
    ("pack", None, "bf16x1", ("wave_packed_fft", "mel_log")),
    ("pack", "bf16x3", "bf16x3", ("wave_packed_fft_bf16", "mel_log")),
    ("roll", None, "bf16x1", ("wave_stft_power", "mel_log_bf16")),
    ("roll", "bf16x3", "bf16x3", ("wave_dft_power_bf16", "mel_log_bf16")),
    ("slice", "bf16x3", None, ("wave_stft_power", "mel_log")),
    ("eo", "bf16x1", "bf16x1", ("wave_dft_power_bf16", "mel_log")),
    ("rolledge", None, "bf16x3", ("wave_stft_power", "mel_log"))], ids=str)
def test_impl_kernels_names_what_each_call_launches(impl, precision, mel_precision, names):
    assert kernels.impl_kernels(impl, precision, mel_precision) == names
    assert set(names) <= set(kernels.LAUNCHES)


def test_cpu_fuse_and_pack_tiers_launch_no_kernel():
    kernels.reset_launch_counts()
    x = torch.from_numpy(X[:1])
    kernels.logmel_waveform(x, CFG, impl="fuse", precision="bf16x1", mel_precision="bf16x3")
    kernels.logmel_waveform(x, CFG, impl="fuse", mel_precision="bf16x1")
    kernels.logmel_waveform(x, CFG, impl="pack", precision="bf16x3")
    assert sum(kernels.LAUNCHES.values()) == 0
